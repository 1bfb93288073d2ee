"""Differential tests on locally synthesized vectors (libvorbisenc), covering
what the reference's downloadable corpora exercise: block switching, 5.1
coupling/Residue2, quality extremes, chained and multiplexed streams.
(Reference corpora: NVorbis.Tests/Utils/TestAssets.cs — unavailable offline.)"""

import io

import numpy as np
import pytest

from vorbispizza_tpu import VorbisReader
from vorbispizza_tpu.testing.encode import (
    chain_streams,
    encode_vorbis,
    make_signal,
    multiplex_streams,
)
from vorbispizza_tpu.testing.oracle import OracleDecoder


def _cmp_oracle(data: bytes, tmp_path, max_abs=1e-6):
    p = tmp_path / "v.ogg"
    p.write_bytes(data)
    with VorbisReader(str(p), clip_samples=False) as r:
        mine = r.read_all(planar=True)
    ref = OracleDecoder(str(p)).read_float()
    assert mine.shape == ref.shape
    assert np.abs(mine.astype(np.float64) - ref.astype(np.float64)).max() <= max_abs
    return mine


def test_block_switching(tmp_path):
    """Transient-heavy signal forces long/short switching (256/2048)."""
    sig = make_signal(2, 2.0, kind="music")
    _cmp_oracle(encode_vorbis(sig, quality=0.4), tmp_path)


def test_multichannel_51(tmp_path):
    """6 channels: polar coupling + Residue2 interleave."""
    sig = make_signal(6, 1.0, kind="music", seed=3)
    _cmp_oracle(encode_vorbis(sig, quality=0.3), tmp_path)


@pytest.mark.parametrize("quality", [-0.1, 0.9])
def test_quality_extremes(quality, tmp_path):
    sig = make_signal(2, 0.7, kind="noise", seed=9)
    _cmp_oracle(encode_vorbis(sig, quality=quality), tmp_path)


def test_low_rate_mono(tmp_path):
    sig = make_signal(1, 0.5, kind="sine", seed=4)
    _cmp_oracle(encode_vorbis(sig, rate=8000, quality=0.1), tmp_path)


@pytest.mark.parametrize(
    "rate,channels,quality",
    [
        (8000, 2, -0.1),   # coupled low-rate floor/residue tuning at min q
        (8000, 1, 1.0),    # low-rate max-quality codebook set
        (11025, 1, 0.3),
        (16000, 2, 0.5),
        (32000, 2, 0.8),
        (44100, 2, 1.0),   # max quality at the standard rate
    ],
)
def test_rate_quality_matrix(rate, channels, quality, tmp_path):
    """libvorbisenc selects a distinct setup vintage (codebooks, floor
    curves, residue partitioning) per rate band; each (band, quality
    corner) is a different header family the decoder must parse and
    synthesize bit-accurately (reference corpora analog:
    NVorbis.Tests/Utils/TestAssets.cs, unavailable offline)."""
    sig = make_signal(channels, 0.4, rate=rate, kind="music",
                      seed=40 + rate % 97 + channels)
    _cmp_oracle(encode_vorbis(sig, rate=rate, quality=quality), tmp_path)


@pytest.mark.parametrize("channels", [3, 4, 5, 7])
def test_channel_layouts(channels, tmp_path):
    """3/4/5/7-channel encoder mappings: each count gets a distinct coupling
    configuration from libvorbisenc (stereo pairs among L/R groups, uncoupled
    center/LFE) — exercises partial-coupling inverse and Residue2 interleave
    widths beyond the stereo/5.1/8ch vectors (reference corpora analog:
    NVorbis.Tests/Utils/TestAssets.cs, unavailable offline)."""
    sig = make_signal(channels, 0.5, kind="music", seed=20 + channels)
    _cmp_oracle(encode_vorbis(sig, quality=0.2), tmp_path)


@pytest.mark.parametrize("rate", [48000, 96000])
def test_high_rate_stereo(rate, tmp_path):
    """48/96 kHz setups use different encoder vintages (codebook sets,
    blocksize/floor tuning) than the 44.1 kHz family."""
    sig = make_signal(2, 0.4, kind="music", seed=31)
    _cmp_oracle(encode_vorbis(sig, rate=rate, quality=0.4), tmp_path)


def test_chained_streams(tmp_path):
    a = encode_vorbis(make_signal(2, 0.5, kind="music", seed=1), serial=111,
                      comments={"TITLE": "A"})
    b = encode_vorbis(make_signal(1, 0.4, kind="sine", seed=2), rate=22050,
                      serial=222, comments={"TITLE": "B"})
    r = VorbisReader(io.BytesIO(chain_streams(a, b)))
    r.initialize()
    assert r.tags.title == "A" and r.channels == 2
    pcm1 = r.read_all(planar=True)
    assert pcm1.shape[1] == 22050
    assert r.find_next_stream()
    assert r.switch_streams(1) is True  # format changed
    assert r.tags.title == "B" and r.channels == 1 and r.sample_rate == 22050
    pcm2 = r.read_all(planar=True)
    assert pcm2.shape[1] == int(0.4 * 44100)  # 17640 source samples @22050


def test_multiplexed_streams(tmp_path):
    a = encode_vorbis(make_signal(2, 0.5, kind="music", seed=1), serial=111)
    b = encode_vorbis(make_signal(1, 0.4, kind="sine", seed=2), rate=22050, serial=222)
    # decode each logical stream alone for ground truth
    ra = VorbisReader(io.BytesIO(a)); ra.initialize(); ga = ra.read_all(planar=True)
    rb = VorbisReader(io.BytesIO(b)); rb.initialize(); gb = rb.read_all(planar=True)
    r = VorbisReader(io.BytesIO(multiplex_streams(a, b)))
    r.initialize()
    r.find_next_stream()
    assert [s._provider.serial for s in r.streams] == [111, 222]
    m1 = r.read_all(planar=True)
    r.switch_streams(1)
    m2 = r.read_all(planar=True)
    np.testing.assert_array_equal(m1, ga)
    np.testing.assert_array_equal(m2, gb)


def test_multiplexed_floor0_and_5_1():
    """Grouped multiplexing whose interleaved logical streams include a
    FLOOR0 stream (hand-built LSP setup, testing/rawstream.py) and a 5.1
    stream (polar coupling + Residue2): the two hardest setup families
    sharing one physical stream. Each logical stream must
    decode identically to its unmultiplexed original — floor0's solo
    oracle parity is pinned by test_rawstream, the 5.1 solo by
    test_multichannel_51, so original-equality here transfers those
    budgets to the multiplexed container."""
    from vorbispizza_tpu.testing.rawstream import make_floor0_stream

    f0 = make_floor0_stream(n_packets=24)  # serial 777
    s51 = encode_vorbis(
        make_signal(6, 0.4, kind="music", seed=9), quality=0.3, serial=333
    )
    muxed = multiplex_streams(f0, s51)
    # ground truth: each logical stream decoded alone
    r0 = VorbisReader(f0); r0.initialize(); g0 = r0.read_all(planar=True)
    r5 = VorbisReader(s51); r5.initialize(); g5 = r5.read_all(planar=True)
    r = VorbisReader(io.BytesIO(muxed))
    r.initialize()
    r.find_next_stream()
    assert [s._provider.serial for s in r.streams] == [777, 333]
    assert [s.channels for s in r.streams] == [1, 6]
    m0 = r.read_all(planar=True)
    r.switch_streams(1)
    m5 = r.read_all(planar=True)
    np.testing.assert_array_equal(m0, g0)
    np.testing.assert_array_equal(m5, g5)
    # truncation fuzz: cutting the interleaved container anywhere must
    # never crash; readable prefixes of both streams still decode
    for frac in (0.3, 0.55, 0.8, 0.95):
        cut = muxed[: int(len(muxed) * frac)]
        rt = VorbisReader(io.BytesIO(cut))
        try:
            rt.initialize()
        except Exception:
            continue  # truncated inside headers: clean refusal
        rt.find_next_stream()
        for k in range(rt.streams_count):
            rt.switch_streams(k)
            rt.read_all(planar=True)


def test_new_stream_veto():
    a = encode_vorbis(make_signal(1, 0.2, kind="sine"), serial=5)
    b = encode_vorbis(make_signal(1, 0.2, kind="sine", seed=1), serial=6)
    seen = []
    r = VorbisReader(
        io.BytesIO(chain_streams(a, b)),
        new_stream_callback=lambda d: seen.append(d) or len(seen) > 1,
    )
    r.initialize()  # first stream vetoed; second accepted
    r.find_next_stream()
    assert len(seen) >= 2
    assert r.streams_count == 1


def test_seek_in_switched_stream(tmp_path):
    sig = make_signal(2, 1.0, kind="music", seed=11)
    data = encode_vorbis(sig, quality=0.5)
    p = tmp_path / "s.ogg"
    p.write_bytes(data)
    r = VorbisReader(str(p), clip_samples=False)
    r.initialize()
    full = r.read_all(planar=True)
    r.seek_to(30000)
    got = r.read_samples(1000, planar=True)
    np.testing.assert_array_equal(got, full[:, 30000:31000])
    r.close()
