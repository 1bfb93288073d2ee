"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that the ('stream', 'frame')-sharded decode step — including the
ppermute halo exchange for the overlap-add boundary — produces exactly the
same PCM as the unsharded ops pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vorbispizza_tpu.dsp.window import full_window
from vorbispizza_tpu.ops.coupling import inverse_couple_batch
from vorbispizza_tpu.ops.floor import floor1_curves
from vorbispizza_tpu.ops.imdct import imdct_window_batch
from vorbispizza_tpu.parallel.mesh import make_mesh, shard_inputs, sharded_decode_step

N = 256
C = 2
XS = (0, 128, 16, 32, 64, 96, 192)  # valid floor1 X list (0 and 1<<rangebits first)
MULT = 2
STEPS = ((0, 1),)


def _random_inputs(rng, S, F):
    P = len(XS)
    residues = rng.standard_normal((S, F, C, N // 2)).astype(np.float32)
    posts = rng.integers(0, 128, size=(S, F, C, P)).astype(np.int32)
    step2 = rng.random((S, F, C, P)) < 0.7
    step2[..., :2] = True
    used = rng.random((S, F, C)) < 0.9
    return residues, posts, step2, used


def _reference(residues, posts, step2, used):
    """Unsharded computation with the same ops + numpy overlap-add."""
    S, F, _, half = residues.shape
    window = full_window(N, 0, N // 2, N // 2, N).astype(np.float32)
    P = len(XS)
    curves = np.asarray(
        floor1_curves(
            posts.reshape(-1, P), step2.reshape(-1, P), used.reshape(-1),
            xs=XS, multiplier=MULT, half=half,
        )
    ).reshape(S, F, C, half)
    res = np.asarray(
        inverse_couple_batch(residues.reshape(S * F, C, half), STEPS)
    ).reshape(S, F, C, half)
    frames = np.asarray(
        imdct_window_batch(jnp.asarray(res * curves), jnp.asarray(window))
    )
    pcm = np.zeros((S, F * half, C), dtype=np.float32)
    for f in range(F):
        prev = frames[:, f - 1, :, half:] if f > 0 else 0.0
        hop = prev + frames[:, f, :, :half]
        pcm[:, f * half : (f + 1) * half] = np.transpose(hop, (0, 2, 1))
    return np.clip(pcm, -0.99999994, 0.99999994)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_sharded_step_matches_unsharded(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough virtual devices")
    mesh = make_mesh(n_devices)
    S = mesh.shape["stream"] * 2
    F = mesh.shape["frame"] * 4
    rng = np.random.default_rng(42)
    residues, posts, step2, used = _random_inputs(rng, S, F)
    window = full_window(N, 0, N // 2, N // 2, N)
    step = sharded_decode_step(
        mesh, n=N, channels=C, xs=XS, multiplier=MULT,
        coupling_steps=STEPS, window=window,
    )
    args = shard_inputs(mesh, residues, posts, step2, used)
    pcm, has_clipped = step(*args)
    ref = _reference(residues, posts, step2, used)
    assert np.asarray(pcm).shape == ref.shape
    np.testing.assert_allclose(np.asarray(pcm), ref, atol=2e-6)
    assert bool(has_clipped) == bool(np.any(np.abs(ref) >= 0.99999994))


# --- production pipeline (models/pipeline.py) under shard_map -----------


@pytest.fixture(scope="module")
def prod_corpus():
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    return [
        encode_vorbis(make_signal(2, 0.4, kind="music", seed=s), quality=0.3)
        for s in range(5)
    ]


@pytest.mark.parametrize("output", ["s16", "f32"])
def test_sharded_corpus_matches_single_device(prod_corpus, output):
    """decode_corpus_sharded (symbol residues, trims, dpack wire, event OLA
    under shard_map over a 1-D stream mesh) == single-device decode_corpus,
    bit exact."""
    from jax.sharding import Mesh

    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(np.array(devs[:4]), axis_names=("stream",))
    sharded = decode_corpus_sharded(prod_corpus, mesh, output=output)
    single = decode_corpus(prod_corpus, output=output)
    assert len(sharded) == len(single)
    for a, b in zip(sharded, single):
        assert a.shape == b.shape
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_corpus_device_tier(prod_corpus):
    """output="device": per-stream PCM stays in device memory (jax
    arrays, no host pull), equal to the single-device device-resident
    tier — the deployment shape, multi-device."""
    from jax.sharding import Mesh

    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(np.array(devs[:4]), axis_names=("stream",))
    sharded = decode_corpus_sharded(prod_corpus, mesh, output="device")
    single = decode_corpus(prod_corpus, output="device")
    assert len(sharded) == len(single)
    for a, b in zip(sharded, single):
        assert isinstance(a, jax.Array)  # stayed on device
        assert a.shape == b.shape
        assert a.dtype == jnp.float32
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_corpus_mixed_setups():
    """Cross-setup sharding: streams of three different setups group by
    channel count, so each shard's merged sub-chunk may contain buckets of
    several sids and _unify_buckets must line them up across shards.
    Result == single-device, bit exact."""
    from jax.sharding import Mesh

    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    corpus = [
        encode_vorbis(
            make_signal(2, 0.4, kind="music", seed=60 + s),
            quality=(0.2, 0.5, 0.8)[s % 3],
        )
        for s in range(6)
    ]
    mesh = Mesh(np.array(devs[:4]), axis_names=("stream",))
    sharded = decode_corpus_sharded(corpus, mesh, output="s16")
    single = decode_corpus(corpus, output="s16")
    for a, b in zip(sharded, single):
        assert a.shape == b.shape
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_corpus_more_streams_than_devices(prod_corpus):
    """Streams partition over the mesh (LPT balance); empty shards legal."""
    from jax.sharding import Mesh

    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(np.array(devs[:8]), axis_names=("stream",))
    sharded = decode_corpus_sharded(prod_corpus, mesh, output="s16")
    single = decode_corpus(prod_corpus, output="s16")
    for a, b in zip(sharded, single):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_partition_indices_balance():
    from vorbispizza_tpu.parallel.corpus import partition_indices

    parts = partition_indices([10, 1, 1, 1, 1, 1, 5, 5], 4)
    assert sorted(i for p in parts for i in p) == list(range(8))
    loads = sorted(
        sum([10, 1, 1, 1, 1, 1, 5, 5][i] for i in p) for p in parts
    )
    assert loads[-1] <= 10  # LPT: the 10-cost stream sits alone
    # fewer items than shards -> empty shards, all indices covered
    parts2 = partition_indices([3, 2], 4)
    assert sorted(i for p in parts2 for i in p) == [0, 1]


def test_sharded_corpus_batch_unsupported_degrades(prod_corpus, monkeypatch):
    """A BatchUnsupported raised inside the sharded run (e.g. prepare-time
    planner rejection) degrades per stream — first to per-device dispatch,
    then to the scalar decoder — instead of aborting the corpus."""
    from jax.sharding import Mesh

    import vorbispizza_tpu.parallel.corpus as pc
    from vorbispizza_tpu.frames import BatchUnsupported
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.models.pipeline import BatchSynthesizer

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(np.array(devs[:4]), axis_names=("stream",))

    def boom(*a, **k):
        raise BatchUnsupported("injected: planner rejects this chunk")

    monkeypatch.setattr(pc, "sharded_chunk_run", boom)
    # the per-device dispatch fallback must also degrade to scalar when
    # prepare itself rejects the stream
    monkeypatch.setattr(BatchSynthesizer, "prepare", boom)
    sharded = pc.decode_corpus_sharded(prod_corpus, mesh, output="s16")
    single = decode_corpus(prod_corpus, output="s16")
    for a, b in zip(sharded, single):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_sharded_corpus_overflow_redispatch():
    """Near-incompressible streams overflow the soft-capacity dpack wire:
    the sharded path must probe the shard headers, re-run the group with
    the full-capacity pack, and still match the single-device decode
    bit-for-bit."""
    from jax.sharding import Mesh

    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    rate = 44100
    corpus = [
        encode_vorbis(
            make_signal(2, 0.8, rate=rate, kind="noise", seed=40 + s),
            rate=rate,
            quality=0.7,
        )
        for s in range(3)
    ]
    devs = jax.devices("cpu")
    mesh = Mesh(np.array(devs[:2]), axis_names=("stream",))
    sharded = decode_corpus_sharded(corpus, mesh, output="s16")
    single = decode_corpus(corpus, output="s16")
    for a, b in zip(sharded, single):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sharded_corpus_all_zero_frame_group():
    """An all-headers-only group has no fused program; every slot falls
    back to the scalar anchor (regression alongside the single-device
    zero-frame guard)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded
    from tests.test_corpus import _headers_only_stream

    empty = _headers_only_stream()
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), axis_names=("stream",))
    outs = decode_corpus_sharded([empty, empty], mesh, output="s16")
    assert [o.shape for o in outs] == [(2, 0), (2, 0)]
