"""VorbisReader(accelerated=True): device-batch-backed streaming surface."""

import numpy as np
import pytest

from vorbispizza_tpu import VorbisReader


def test_accelerated_reads_match_scalar(testfiles):
    for path in testfiles:
        r = VorbisReader(str(path))
        r.initialize()
        ref = r.read_all(planar=False)
        a = VorbisReader(str(path), accelerated=True)
        a.initialize()
        chunks = []
        while True:
            c = a.read_samples(3001)
            if c.shape[0] == 0:
                break
            chunks.append(c)
        got = np.concatenate(chunks, axis=0)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2e-6


def test_accelerated_seek(testfile1):
    r = VorbisReader(str(testfile1))
    r.initialize()
    ref = r.read_all(planar=False)
    a = VorbisReader(str(testfile1), accelerated=True)
    a.initialize()
    a.seek_to(5000)
    got = a.read_samples(256)
    assert np.abs(got - ref[5000:5256]).max() <= 2e-6
    assert a.sample_position == 5256
    a.seek_to(0.05, seconds=True)
    got = a.read_samples(128)
    pos = int(0.05 * a.sample_rate)
    assert np.abs(got - ref[pos : pos + 128]).max() <= 2e-6


def test_accelerated_metadata(testfile1):
    a = VorbisReader(str(testfile1), accelerated=True)
    a.initialize()
    assert a.channels == 1 and a.sample_rate == 44100
    assert a.total_samples == 17318
    assert a.tags is not None and a.stats is not None


def test_accelerated_seek_gap_stream_matches_scalar(testfiles):
    """Granule-space seeking on a resync/gap stream (reference
    StreamDecoder.SeekTo:817 seeks granules; the accelerated buffer is
    gap-free): after corrupting a mid-stream page, seeks PAST the gap must
    return the same PCM from both decoders."""
    path = [p for p in testfiles if p.stem == "3test"][0]
    raw = bytearray(path.read_bytes())
    raw[60000] ^= 0xFF  # CRC-kill one audio page -> sequence gap + resync
    data = bytes(raw)

    r = VorbisReader(data)
    r.initialize()
    a = VorbisReader(data, accelerated=True)
    a.initialize()
    total = r.total_samples
    assert a.total_samples == total

    for pos in (0, 1000, total // 2, total - 4096):
        r.seek_to(pos)
        want = r.read_samples(1024, planar=True)
        a.seek_to(pos)
        got = a.read_samples(1024, planar=True)
        assert got.shape == want.shape, pos
        assert np.abs(got - want).max() <= 2e-6, pos
        assert a.sample_position == r.sample_position, pos


def test_accelerated_stats_exact_audio_bits(testfile1):
    """Accelerated and scalar paths agree EXACTLY on audio/waste bit
    accounting: the C++ front end records bits consumed per packet
    (frontend.cpp meta[4]), matching the scalar BitReader's bits_read
    (reference StreamStats.cs:94-122 definition)."""
    from vorbispizza_tpu import native

    if not native.available():
        pytest.skip("native front end unavailable")
    a = VorbisReader(str(testfile1), accelerated=True)
    a.initialize()
    a.read_all()
    s = VorbisReader(str(testfile1))
    s.initialize()
    s.read_all()
    assert a.stats.audio_bits == s.stats.audio_bits
    assert a.stats.waste_bits == s.stats.waste_bits
    assert a.stats.container_bits == s.stats.container_bits
    assert a.stats.packet_count == s.stats.packet_count
