"""Corpus decode + batch pipeline edge cases (chained streams, s16 output,
CLI WAV tool)."""

import numpy as np
import pytest

from vorbispizza_tpu.models.corpus import decode_corpus
from vorbispizza_tpu.models.pipeline import decode_file_batch
from vorbispizza_tpu.reader import VorbisReader


@pytest.fixture(scope="module")
def small_corpus():
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    return [
        encode_vorbis(
            make_signal(2, 0.6, kind="music", seed=s), quality=0.4
        )
        for s in range(3)
    ]


def scalar_decode(data):
    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


def test_decode_corpus_matches_scalar(small_corpus):
    outs = decode_corpus(small_corpus, n_workers=2)
    for data, got in zip(small_corpus, outs):
        ref = scalar_decode(data)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-6


def test_decode_corpus_s16(small_corpus):
    outs = decode_corpus(small_corpus[:1], output="s16")
    ref = scalar_decode(small_corpus[0])
    s16 = np.clip(np.rint(ref.astype(np.float64) * 32768.0), -32768, 32767)
    assert outs[0].dtype == np.int16
    assert np.abs(outs[0].astype(np.int64) - s16.astype(np.int64)).max() <= 1


def test_decode_corpus_device_resident(small_corpus):
    outs = decode_corpus(small_corpus[:1], output="device")
    import jax

    assert isinstance(outs[0], jax.Array)
    ref = scalar_decode(small_corpus[0])
    got = np.clip(np.asarray(outs[0]), -0.99999994, 0.99999994)
    assert np.abs(got - ref).max() <= 2e-6


def test_batch_chained_stream():
    """Chained physical stream: the batch pipeline decodes the first logical
    stream; each chain link is a separate provider (reader parity)."""
    from vorbispizza_tpu.testing.encode import chain_streams, encode_vorbis, make_signal

    a = encode_vorbis(make_signal(1, 0.4, kind="sine", seed=1), quality=0.2)
    b = encode_vorbis(make_signal(1, 0.3, kind="sine", seed=2), quality=0.2)
    chained = chain_streams(a, b)
    ref = scalar_decode(a)
    got = decode_file_batch(chained)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2e-6


def test_cli_wav_tool(tmp_path, testfile1):
    from vorbispizza_tpu.tools.decode import main

    rc = main(["--scalar", "--out", str(tmp_path), str(testfile1)])
    assert rc == 0
    wav = tmp_path / (testfile1.stem + ".wav")
    data = wav.read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    # IEEE float stereo... 1test is mono 44.1k; 17318 samples * 4 bytes
    assert len(data) == 44 + 17318 * 4


def test_batch_multiplexed_streams():
    """Multiplexed physical stream: each logical stream batch-decodes to the
    same PCM as its standalone encode (BASELINE config #4)."""
    import io

    from vorbispizza_tpu.models.pipeline import decode_stream_batch
    from vorbispizza_tpu.ogg.container import OggContainer
    from vorbispizza_tpu.testing.encode import (
        encode_vorbis,
        make_signal,
        multiplex_streams,
    )

    a = encode_vorbis(make_signal(1, 0.4, kind="sine", seed=3), quality=0.2,
                      serial=111)
    b = encode_vorbis(make_signal(2, 0.3, kind="music", seed=4), quality=0.3,
                      serial=222)
    muxed = multiplex_streams(a, b)
    container = OggContainer(io.BytesIO(muxed))
    assert container.try_init()
    container.find_next_stream()
    assert len(container.providers) >= 2
    for src, provider in zip((a, b), container.providers[:2]):
        ref = scalar_decode(src)
        got = decode_stream_batch(provider)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-6


def test_batch_multiplexed_floor0_and_5_1():
    """The two hardest setup families sharing one physical stream — a
    hand-built FLOOR0 (LSP) logical stream and a 5.1 (polar coupling +
    Residue2) stream — each batch-decoded straight off the multiplexed
    container's providers (the scalar-path twin lives in
    test_synth_vectors; this pins the BATCH pipeline's demux
    integration). Floor0 is f32 on device like libvorbis, so its budget
    is vs the scalar decode at the device tolerance."""
    import io

    from vorbispizza_tpu.models.pipeline import decode_stream_batch
    from vorbispizza_tpu.ogg.container import OggContainer
    from vorbispizza_tpu.testing.encode import (
        encode_vorbis,
        make_signal,
        multiplex_streams,
    )
    from vorbispizza_tpu.testing.rawstream import make_floor0_stream

    f0 = make_floor0_stream(n_packets=24)  # serial 777
    s51 = encode_vorbis(
        make_signal(6, 0.4, kind="music", seed=9), quality=0.3, serial=333
    )
    muxed = multiplex_streams(f0, s51)
    container = OggContainer(io.BytesIO(muxed))
    assert container.try_init()
    container.find_next_stream()
    assert [p.serial for p in container.providers[:2]] == [777, 333]
    for src, provider, tol in (
        (f0, container.providers[0], 1e-4),  # floor0: f32 LSP synth
        (s51, container.providers[1], 2e-6),
    ):
        ref = scalar_decode(src)
        got = decode_stream_batch(provider)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol


def test_decode_corpus_multi_device(small_corpus):
    """Stream-level data parallelism: merged chunks round-robin across
    devices produce identical PCM to the single-device path."""
    import jax

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs multiple devices")
    ref = decode_corpus(small_corpus)
    got = decode_corpus(
        small_corpus, devices=devs, max_batch_bytes=1  # one chunk per stream
    )
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", ["one_stream", "two_streams", "all"])
def test_plan_chunks_matches_dispatch(small_corpus, monkeypatch, cap):
    """plan_chunks names the chunks decode_corpus dispatches, in order."""
    from vorbispizza_tpu.models import corpus

    costs = [
        sum(b.batch_cost for b in corpus._front_end(s)[3]) for s in small_corpus
    ]
    max_batch_bytes = {
        "one_stream": 1,
        "two_streams": costs[0] + costs[1],
        "all": 10**12,
    }[cap]
    want = {
        "one_stream": [[0], [1], [2]],
        "two_streams": [[0, 1], [2]],
        "all": [[0, 1, 2]],
    }[cap]
    assert corpus.plan_chunks(small_corpus, max_batch_bytes) == want

    sizes = []
    merge = corpus.merge_streams

    def recording_merge(items):
        sizes.append(len(items))
        return merge(items)

    monkeypatch.setattr(corpus, "merge_streams", recording_merge)
    decode_corpus(small_corpus, max_batch_bytes=max_batch_bytes)
    assert sizes == [len(c) for c in want]


def test_corpus_front_end_batch_unsupported_falls_back(small_corpus, monkeypatch):
    """A stream the batch planner rejects at FRONT-END time (BatchUnsupported
    from build_plan, e.g. overlapping granule cuts on trimmed input) must
    fall back to the exact scalar decode instead of aborting the corpus."""
    import vorbispizza_tpu.models.corpus as corpus_mod
    from vorbispizza_tpu.frames import BatchUnsupported

    real = corpus_mod._front_end
    bad = small_corpus[1]

    def flaky_front_end(source):
        if source is bad:
            raise BatchUnsupported("injected: plan-time rejection")
        return real(source)

    monkeypatch.setattr(corpus_mod, "_front_end", flaky_front_end)
    for batched in (True, False):
        outs = decode_corpus(small_corpus, batched=batched)
        for data, got in zip(small_corpus, outs):
            ref = scalar_decode(data)
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 2e-6


def test_decode_corpus_mixed_setups():
    """Heterogeneous corpus (>=3 distinct encoder settings, mixed channel
    counts): batched decode must group by setup identity, keep input order,
    and stay exact per stream."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    corpus = []
    for s, (ch, q) in enumerate(
        [(2, 0.4), (1, 0.1), (2, 0.7), (2, 0.4), (1, 0.1), (2, 0.4)]
    ):
        corpus.append(
            encode_vorbis(
                make_signal(ch, 0.5, kind="music", seed=10 + s), quality=q
            )
        )
    outs = decode_corpus(corpus, n_workers=3)
    assert len(outs) == len(corpus)
    for data, got in zip(corpus, outs):
        ref = scalar_decode(data)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-6

    # same-settings streams must actually share one parsed setup (the
    # compiled-program grouping key)
    from vorbispizza_tpu.models.corpus import _front_end

    s0 = _front_end(corpus[0])[0]
    s3 = _front_end(corpus[3])[0]
    assert s0 is s3


def test_decode_corpus_channel_layouts():
    """3/4/5-channel streams through the BATCHED device path: per-channel-count
    synthesizers, partial coupling configurations (coupled L/R pairs plus
    uncoupled center/LFE), Residue2 interleave at odd widths."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    corpus = [
        encode_vorbis(
            make_signal(ch, 0.4, kind="music", seed=50 + ch), quality=0.2
        )
        for ch in (3, 4, 5)
    ]
    outs = decode_corpus(corpus, n_workers=2)
    for data, got in zip(corpus, outs):
        ref = scalar_decode(data)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-6


def test_cross_setup_chunk_merges_to_one_program():
    """Streams of THREE different setups (qualities) with one channel
    count merge into ONE chunk and decode through ONE fused program:
    bucket keys carry setup identity (BucketKey.sid), so the
    program-family count tracks corpus composition, not the number
    of encoder settings."""
    from vorbispizza_tpu.models import corpus as corpus_mod
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    corpus = [
        encode_vorbis(
            make_signal(2, 0.5, kind="music", seed=40 + s), quality=q
        )
        for s, q in enumerate((0.2, 0.5, 0.8))
    ]
    saved = dict(corpus_mod._SYNTH_CACHE)
    corpus_mod._SYNTH_CACHE.clear()
    try:
        outs = decode_corpus(corpus)
        synth = corpus_mod._SYNTH_CACHE.get(2)
        assert synth is not None, "batched path did not run"
        assert len(synth.setups) == 3
        fused = [k for k in synth._fns if k[0] == "fused"]
        assert len(fused) == 1, f"expected one fused program, got {fused}"
        # and the merged multi-setup program is exact per stream
        for data, got in zip(corpus, outs):
            ref = scalar_decode(data)
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 2e-6
    finally:
        corpus_mod._SYNTH_CACHE.clear()
        corpus_mod._SYNTH_CACHE.update(saved)


def test_decode_corpus_s16_clipping_extremes():
    """Every s16 wire format at the clip rails: a hot signal (inter-sample
    peaks past full scale) must quantize identically to the scalar s16
    definition through each transport (delta block-pack, byte planes,
    raw)."""
    from vorbispizza_tpu.config import VorbisConfig
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    sig = make_signal(2, 0.4, kind="music", seed=77) * 1.6  # drive into clip
    data = encode_vorbis(sig, quality=0.6)
    ref = scalar_decode(data)
    want = np.clip(
        np.rint(np.clip(ref, -0.99999994, 0.99999994).astype(np.float64) * 32768.0),
        -32768,
        32767,
    ).astype(np.int16)
    saved = VorbisConfig.default.s16_wire
    outs = {}
    try:
        for wire in ("dpack", "planes", "raw"):
            VorbisConfig.default.s16_wire = wire
            out = decode_corpus([data], output="s16")[0]
            assert out.dtype == np.int16
            assert np.abs(out.astype(np.int32) - want.astype(np.int32)).max() <= 1, wire
            outs[wire] = out
    finally:
        VorbisConfig.default.s16_wire = saved
    # all wire formats are lossless: identical bytes
    assert np.array_equal(outs["dpack"], outs["raw"])
    assert np.array_equal(outs["planes"], outs["raw"])
    # the signal actually clips (the rails are exercised)
    assert (np.abs(want.astype(np.int32)) >= 32767).any()


def test_synth_program_cache_bounded_and_evicts_cleanly(small_corpus, monkeypatch):
    """The process-wide synthesizer's program cache is a bounded LRU:
    force eviction between two decodes of the same corpus and check the
    re-admitted programs still produce identical PCM."""
    from vorbispizza_tpu.models.pipeline import _LRUPrograms

    monkeypatch.setattr(_LRUPrograms, "MAX", 2)
    first = decode_corpus(small_corpus, output="s16")
    # a second pass re-traces whatever was evicted (cache now holds at
    # most 2 entries) — results must be unchanged
    second = decode_corpus(small_corpus, output="s16")
    for a, b in zip(first, second):
        assert np.array_equal(a, b)


def test_corpus_on_error_policies():
    """A malformed file either aborts the corpus (on_error='raise', the
    reference per-file InvalidDataException contract) or is isolated to a
    None slot while every other file decodes (on_error='none', the
    production corpus-service contract)."""
    from vorbispizza_tpu import errors
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    good = encode_vorbis(make_signal(2, 0.4, kind="music", seed=1), quality=0.3)
    bad = good[:300] + b"\x00" * 50  # truncated headers + junk
    with pytest.raises(errors.VorbisError):
        decode_corpus([good, bad, good], output="s16")
    outs = decode_corpus([good, bad, good], output="s16", on_error="none")
    assert outs[1] is None
    assert outs[0] is not None and np.array_equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        decode_corpus([good], on_error="ignore")


def test_sharded_corpus_on_error_none():
    import jax
    from jax.sharding import Mesh

    from vorbispizza_tpu import errors
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    good = encode_vorbis(make_signal(2, 0.4, kind="music", seed=2), quality=0.3)
    bad = b"OggS" + b"\x17" * 200
    devs = jax.devices("cpu")
    mesh = Mesh(np.array(devs[:2]), axis_names=("stream",))
    with pytest.raises(errors.VorbisError):
        decode_corpus_sharded([good, bad], mesh, output="s16")
    outs = decode_corpus_sharded([good, bad], mesh, output="s16", on_error="none")
    assert outs[1] is None
    single = decode_corpus([good], output="s16")[0]
    assert np.array_equal(outs[0], single)


def test_corpus_timer_without_mark_not_mutated():
    """A caller-supplied timer lacking mark() (older DecodeTimer shape,
    possibly slotted) is wrapped, not monkey-patched: the caller's
    object gains no attributes and the decode still works."""
    import contextlib

    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    class SlimTimer:
        __slots__ = ("stages",)

        def __init__(self):
            self.stages = {}

        @contextlib.contextmanager
        def stage(self, name):
            yield
            self.stages[name] = True

        def count(self, name, v=1):
            pass

    t = SlimTimer()
    good = encode_vorbis(make_signal(2, 0.3, kind="sine", seed=7), quality=0.3)
    outs = decode_corpus([good], output="s16", timer=t)
    assert outs[0] is not None and not hasattr(t, "mark")
    assert t.stages  # stages flowed through the adapter


def _headers_only_stream(seed=1):
    """Valid ident/comment/setup headers, zero audio pages: the scalar
    decoder yields [C, 0]; plans have no frames."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    data = encode_vorbis(make_signal(2, 0.3, kind="sine", seed=seed), quality=0.3)
    offs, i = [], 0
    while True:
        j = data.find(b"OggS", i)
        if j < 0:
            break
        offs.append(j)
        i = j + 4
    return data[: offs[2]]


def test_corpus_zero_frame_stream():
    """A headers-only member (no decodable audio frames) must decode to
    an empty array via the scalar fallback, alone and sharing a corpus
    with normal streams — not crash the fused-program builder
    (regression: tools/fuzz corpus trial seed 61010)."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    empty = _headers_only_stream()
    outs = decode_corpus([empty], output="s16")
    assert outs[0].shape == (2, 0)
    good = encode_vorbis(make_signal(2, 0.3, kind="sine", seed=2), quality=0.3)
    outs = decode_corpus([empty, good], output="s16")
    assert outs[0].shape == (2, 0) and outs[1].shape[1] > 0
    assert decode_corpus([empty], output="f32")[0].shape == (2, 0)
