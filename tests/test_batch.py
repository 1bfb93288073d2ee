"""Batch (device) pipeline vs the scalar anchor, plus ops unit tests.

Tolerance context: the scalar decoder is float64 and bit-exact (±2 LSB s16)
vs native libvorbis; the device pipeline is float32 with HIGHEST-precision
matmuls, targeted at ≤1e-6 max-abs PCM error (BASELINE.md)."""

import numpy as np
import pytest

from vorbispizza_tpu.dsp.imdct import imdct as imdct_scalar
from vorbispizza_tpu.models.pipeline import decode_file_batch
from vorbispizza_tpu.reader import VorbisReader
from vorbispizza_tpu.setup.mapping import inverse_couple

# On the GPU the batch pipeline is held to the 1e-6 BASELINE budget vs the
# float64 anchor (chip_smoke.py, bench.py). The CPU test backend's f32 dot
# accumulation is slightly noisier (~1.01e-6 worst sample on 3test), so the
# CI gate allows 2e-6 here.
TOL = 2e-6


def scalar_decode(data_or_path):
    r = VorbisReader(data_or_path)
    r.initialize()
    return r.read_all(planar=True)


@pytest.mark.parametrize("name", ["1test.ogg", "3test.ogg", "issue6test.ogg"])
def test_batch_matches_scalar_reference_files(name, testfiles):
    path = str(testfiles[0].parent / name)
    ref = scalar_decode(path)
    got = decode_file_batch(path)
    assert got.shape == ref.shape
    assert np.abs(ref - got).max() <= TOL


def test_batch_block_switching(tmp_path):
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(2, 1.0, kind="music")
    data = encode_vorbis(sig, quality=0.5)
    ref = scalar_decode(data)
    got = decode_file_batch(data)
    assert got.shape == ref.shape
    assert np.abs(ref - got).max() <= TOL


def test_batch_multichannel_51(tmp_path):
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(6, 0.5, kind="music", seed=3)
    data = encode_vorbis(sig, quality=0.3)
    ref = scalar_decode(data)
    got = decode_file_batch(data)
    assert got.shape == ref.shape
    assert np.abs(ref - got).max() <= TOL


# -- ops units ----------------------------------------------------------------------


def test_imdct_op_matches_scalar():
    from vorbispizza_tpu.ops.imdct import imdct_window_batch

    rng = np.random.default_rng(0)
    for n in (128, 512, 2048):
        x = rng.standard_normal((5, n // 2)).astype(np.float32)
        w = np.ones(n, dtype=np.float32)
        ref = imdct_scalar(x.astype(np.float64), n)
        got = np.asarray(imdct_window_batch(x, w))
        scale = max(1.0, np.abs(ref).max())
        assert np.abs(ref - got).max() / scale < 5e-6


def test_coupling_op_matches_scalar():
    from vorbispizza_tpu.ops.coupling import inverse_couple_batch

    rng = np.random.default_rng(1)
    res = rng.integers(-40, 40, size=(7, 4, 64)).astype(np.float32)
    steps = ((0, 1), (2, 3), (0, 2))
    got = np.asarray(inverse_couple_batch(res, steps))
    ref = res.astype(np.float64).copy()
    for f in range(7):
        for m, a in reversed(steps):
            ref[f, m], ref[f, a] = inverse_couple(ref[f, m], ref[f, a])
    assert np.abs(got - ref).max() == 0.0


def test_overlap_add_shifted_sum():
    import jax.numpy as jnp

    from vorbispizza_tpu.ops.ola import overlap_add

    n = 8
    frames = np.arange(2 * 1 * n, dtype=np.float32).reshape(2, 1, n) + 1
    offsets = np.array([-2, 2], dtype=np.int32)  # first frame partially OOB
    out = np.asarray(
        overlap_add(jnp.zeros((1, 10), dtype=jnp.float32), jnp.asarray(frames),
                    jnp.asarray(offsets))
    )
    expect = np.zeros((1, 10), dtype=np.float32)
    expect[0, 0:6] += frames[0, 0, 2:]  # rows at -2..-1 dropped
    expect[0, 2:10] += frames[1, 0]
    assert np.array_equal(out, expect)


def test_chunked_long_stream_decode_identical():
    """split_plan chunking (bounded-memory long-stream decode) is per-sample
    identical to the unsplit decode, across block-switch boundaries."""
    import io

    from vorbispizza_tpu.models.pipeline import decode_stream_batch
    from vorbispizza_tpu.ogg.container import OggContainer
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    data = encode_vorbis(make_signal(2, 1.2, kind="music", seed=11), quality=0.4)

    def decode(max_frames):
        c = OggContainer(io.BytesIO(data))
        c.try_init()
        return decode_stream_batch(c.providers[0], max_frames=max_frames)

    ref = decode(None)
    for mf in (7, 16, 50):
        got = decode(mf)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_batch_eight_channels():
    """8-channel uncoupled stream (channel-count scaling beyond 5.1)."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(8, 0.4, kind="music", seed=21)
    data = encode_vorbis(sig, quality=0.3)
    ref = scalar_decode(data)
    got = decode_file_batch(data)
    assert got.shape == ref.shape and got.shape[0] == 8
    assert np.abs(ref - got).max() <= TOL


def test_gmap_tier_i32_matches_u16():
    """Forcing the 32-bit gather-map tier (large merged chunks) decodes
    identically to the default 16-bit tier."""
    from vorbispizza_tpu.models.pipeline import BatchSynthesizer
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    data = encode_vorbis(make_signal(2, 0.8, kind="music", seed=5), quality=0.4)
    ref = decode_file_batch(data)
    saved = BatchSynthesizer.GMAP_U16_MAX
    try:
        BatchSynthesizer.GMAP_U16_MAX = 0  # every bucket takes the i32 tier
        got = decode_file_batch(data)
    finally:
        BatchSynthesizer.GMAP_U16_MAX = saved
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [3, 4, 7])
def test_batch_odd_channel_counts_s16_wire(channels):
    """3/4/7-channel streams through the full corpus s16 (dpack) path:
    covers the uncoupled multichannel mappings between stereo and 8ch and
    the pack wire's unpaired-trailing-channel inter-candidate edge
    (ops/pcm_pack.pair_partner). Reference mapping semantics:
    /root/reference/NVorbis/Mapping.cs."""
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(channels, 0.5, kind="music", seed=30 + channels)
    data = encode_vorbis(sig, quality=0.3)
    ref = scalar_decode(data)
    q = np.clip(np.rint(ref.astype(np.float64) * 32768.0), -32768, 32767)
    got = decode_corpus([data], output="s16")[0]
    assert got.shape == q.shape and got.shape[0] == channels
    assert np.abs(got.astype(np.int64) - q.astype(np.int64)).max() <= 1


@pytest.mark.parametrize(
    "rate,bitrate",
    [(44100, 128000), (8000, 24000), (48000, 256000)],
)
def test_bitrate_managed_streams(rate, bitrate):
    """Bitrate-MANAGED encoder setups (vorbis_encode_init nominal mode):
    a different codebook/floor vintage than the VBR-quality corpus, at
    telephone / CD / studio rates. Decoded through the batch pipeline and
    gated against the scalar anchor."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(2, 0.6, rate=rate, kind="music", seed=60)
    data = encode_vorbis(sig, rate=rate, bitrate=bitrate)
    ref = scalar_decode(data)
    got = decode_file_batch(data)
    assert got.shape == ref.shape
    assert np.abs(ref - got).max() <= TOL
