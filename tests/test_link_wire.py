"""Link-aware wire selection (config.s16_rice): the rice mode only pays
on thin links, so "auto" resolves it from the measured d2h rate. Width-only packs must stay losslessly decodable by
the unchanged host unpack (a rice wire with zero rice blocks), and the
resolution logic must pick rice below the threshold and width-only
above it."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vorbispizza_tpu.config import VorbisConfig
from vorbispizza_tpu.ops.pcm_pack import pack_pcm, unpack_pcm
from vorbispizza_tpu.utils import link


def _smooth(c, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.standard_normal(n)
    return np.stack(
        [(x * 32767 * (1 - 0.1 * k)).astype(np.int32) for k in range(c)]
    )


def test_width_only_pack_roundtrips_and_sets_no_rice_flags():
    q = _smooth(2, 44100)
    payload, nbytes, widx, cuts = jax.jit(
        lambda a: pack_pcm(a, rice=False)
    )(jnp.asarray(q))
    nb = int(nbytes)
    data = np.asarray(payload[:nb])
    widx_h = np.asarray(widx)
    cuts_h = np.asarray(cuts)
    assert not np.any(widx_h & 0x80), "rice flag set in width-only pack"
    assert not np.any(cuts_h), "unary cuts nonzero in width-only pack"
    got = unpack_pcm(data, widx_h, 2, q.shape[1], cuts_h)
    np.testing.assert_array_equal(got, q.astype(np.int16))


def test_rice_beats_width_only_on_music_bytes():
    q = _smooth(2, 44100)
    _, nb_r, _, _ = jax.jit(lambda a: pack_pcm(a, rice=True))(
        jnp.asarray(q)
    )
    _, nb_w, _, _ = jax.jit(lambda a: pack_pcm(a, rice=False))(
        jnp.asarray(q)
    )
    assert int(nb_r) < int(nb_w)


def test_auto_resolution_follows_link_rate(monkeypatch):
    from vorbispizza_tpu.models.pipeline import BatchSynthesizer

    cfg = VorbisConfig.default
    monkeypatch.setattr(cfg, "s16_rice", "auto")
    try:
        link.d2h_rate_estimate(force=30e6)  # thin link
        assert BatchSynthesizer._resolve_rice() is True
        link.d2h_rate_estimate(force=500e6)  # PCIe-class link
        assert BatchSynthesizer._resolve_rice() is False
        monkeypatch.setattr(cfg, "s16_rice", "on")
        assert BatchSynthesizer._resolve_rice() is True
        monkeypatch.setattr(cfg, "s16_rice", "off")
        assert BatchSynthesizer._resolve_rice() is False
    finally:
        # the next caller in this worker measures again (+inf on CPU)
        link.reset()


def test_failed_probe_raises_and_caches_nothing(monkeypatch):
    """A link probe that fails must raise, not cache a guessed rate that
    would pick the wire for the whole process."""
    import jax

    def no_transfer(*a, **k):
        raise RuntimeError("transfer failed")

    link.reset()
    try:
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(jax, "device_put", no_transfer)
        with pytest.raises(RuntimeError, match="transfer failed"):
            link.d2h_rate_estimate()
        assert link._cached is None
    finally:
        monkeypatch.undo()
        link.reset()
    assert link.d2h_rate_estimate() == float("inf")  # CPU backend


@pytest.mark.parametrize("mode", ["on", "off"])
def test_corpus_decodes_identically_either_wire(monkeypatch, mode):
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.reader import VorbisReader
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    monkeypatch.setattr(VorbisConfig.default, "s16_rice", mode)
    data = encode_vorbis(
        make_signal(2, 1.0, kind="music", seed=11), quality=0.4
    )
    r = VorbisReader(io.BytesIO(data))
    r.initialize()
    ref = r.read_all(planar=True)
    want = np.clip(
        np.rint(ref.astype(np.float64) * 32768.0), -32768, 32767
    ).astype(np.int64)
    got = decode_corpus([data], output="s16")[0].astype(np.int64)
    assert got.shape == want.shape
    assert int(np.abs(got - want).max()) <= 1
