"""Offline robustness fuzzer: randomized encoder configs, stream
corruption, and chained/multiplexed compositions against the scalar
decoder and the batch pipeline.

The compact in-suite versions (tests/test_fuzz.py) run 6+12 trials; this
harness runs until a wall-clock budget expires and prints a repro line
for every failure, so long idle windows can buy real coverage. The
robustness contract checked on every trial:

- a corrupt stream either raises ``VorbisError`` (loud rejection) or
  decodes; any OTHER exception is a bug (reference analog: the
  NVorbis fuzz corpora, /root/reference/NVorbis.Tests/OggTests.cs);
- whenever both paths decode, batch == scalar within 2e-6 (CPU budget);
- no trial may wedge: a trial slower than _SLOW_S is reported.

CPU-only — forces jax_platforms=cpu so fuzzing never occupies the
accelerator.

Usage: python -m vorbispizza_tpu.tools.fuzz [budget_seconds=300] [seed0=0]
           [shapes]
``shapes`` (optional) is a comma-list restricting the trial pool (e.g.
``corpus`` or ``seek,corrupt``) for targeted regression hunting.
Exit status 1 if any trial failed.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

#: wedge heuristic: corpus/seek trials legitimately absorb tens of
#: seconds of fresh-signature CPU compiles when the one-vCPU host is
#: contended, so only multi-minute trials are suspicious
_SLOW_S = 120.0

_RATES = (8000, 11025, 16000, 22050, 32000, 44100, 48000, 96000)
_CHANNELS = (1, 2, 3, 4, 5, 6, 8)


def _force_cpu():
    import os

    # virtual CPU devices BEFORE the first jax import: the corpus trial
    # round-robins devices and the sharded trial builds a stream mesh
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vorbispizza_tpu.utils import cache

    cache.configure(jax)


def _random_stream(rng: np.random.Generator, serial: int = 1) -> bytes:
    """Encode a random (channels, rate, quality|bitrate, signal) stream.
    Raises RuntimeError when libvorbisenc rejects the combination."""
    from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

    ch = int(rng.choice(_CHANNELS))
    rate = int(rng.choice(_RATES))
    kind = str(rng.choice(["music", "sine", "noise"]))
    sig = make_signal(ch, float(rng.uniform(0.25, 0.8)), rate=rate, kind=kind,
                      seed=int(rng.integers(0, 2**31)))
    if rng.random() < 0.25:  # bitrate-managed vintage
        bitrate = int(rng.choice([32000, 64000, 128000, 256000])) * max(1, ch // 2)
        return encode_vorbis(sig, rate=rate, serial=serial, bitrate=bitrate)
    return encode_vorbis(sig, rate=rate, serial=serial,
                         quality=float(rng.uniform(-0.1, 1.0)))


def _corrupt(rng: np.random.Generator, data: bytes) -> bytes:
    """One random mutation. Header bytes are fair game: corrupt headers
    must be rejected loudly, not crash."""
    bad = bytearray(data)
    mode = str(rng.choice(["bitflip", "truncate", "shear", "dup", "swap", "zero"]))
    if mode == "bitflip":
        for pos in rng.integers(0, len(bad), size=int(rng.integers(1, 8))):
            bad[int(pos)] ^= int(rng.integers(1, 256))
    elif mode == "truncate":
        bad = bad[: int(rng.integers(1, len(bad)))]
    elif mode == "shear":
        cut = int(rng.integers(0, len(bad) - 1))
        del bad[cut: cut + int(rng.integers(1, 5000))]
    elif mode == "dup":  # duplicate a span in place (fake page replay)
        cut = int(rng.integers(0, len(bad) - 1))
        span = bytes(bad[cut: cut + int(rng.integers(100, 6000))])
        bad[cut:cut] = span
    elif mode == "swap":  # transpose two spans (page reorder analog)
        n = len(bad)
        a, b = sorted(int(x) for x in rng.integers(0, max(1, n - 4000), size=2))
        w = int(rng.integers(100, 4000))
        bad[a: a + w], bad[b: b + w] = bad[b: b + w], bad[a: a + w]
    else:
        cut = int(rng.integers(0, len(bad) - 1))
        w = int(rng.integers(100, 6000))
        bad[cut: cut + w] = bytes(min(w, len(bad) - cut))
    return bytes(bad)


def _decode_scalar(data: bytes):
    from vorbispizza_tpu.reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    out = [r.read_all(planar=True)]
    while r.find_next_stream():  # walk every logical stream (chains/mux)
        if r.switch_streams(r.streams_count - 1):
            pass
        out.append(r.read_all(planar=True))
    return out


def _seek_trial(rng: np.random.Generator) -> str:
    """Randomized seek differential vs native libvorbisfile: after seeking
    both to the same sample, the next 512 samples must agree within the
    s16 band (the tests/test_seek_oracle.py contract, randomized over
    encoder configs, positions, and seek direction)."""
    import os
    import tempfile

    from vorbispizza_tpu.reader import VorbisReader
    from vorbispizza_tpu.testing.oracle import OracleDecoder

    try:
        data = _random_stream(rng)
    except RuntimeError:
        return "skip"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.ogg")
        with open(path, "wb") as f:
            f.write(data)
        nat = OracleDecoder(path)
        r = VorbisReader(path, accelerated=bool(rng.random() < 0.5))
        r.initialize()
        total = min(r.total_samples, nat.total)
        if total < 4096:
            return "skip"
        for pos in rng.integers(0, total - 1024, size=4):  # unsorted:
            # backward seeks exercise the bisection restart + preroll
            pos = int(pos)
            nat.seek(pos)
            want = nat.read_float_n(512)
            r.seek_to(pos)
            got = r.read_samples(512).T
            m = min(want.shape[1], got.shape[1])
            assert m >= 256, (pos, m)
            dw = np.clip(np.rint(want[:, :m].astype(np.float64) * 32768.0),
                         -32768, 32767)
            dg = np.clip(np.rint(got[:, :m].astype(np.float64) * 32768.0),
                         -32768, 32767)
            assert np.abs(dg - dw).max() <= 2, pos
    return "ok"


def _verify_against_scalar(sources, outs, output, label):
    """Shared contract check for the corpus-family trials: a None slot is
    acceptable only when the scalar decoder also rejects; when both
    produce PCM they must agree (f32 within the 2e-6 CPU budget, s16
    within 2 LSB — the scalar fallback quantizes from f64, see
    models/corpus.py)."""
    from vorbispizza_tpu.errors import VorbisError
    from vorbispizza_tpu.reader import VorbisReader

    for src, got in zip(sources, outs):
        try:
            r = VorbisReader(src)
            r.initialize()
            ref = r.read_all(planar=True)  # first logical stream
        except VorbisError:
            continue  # scalar rejects: any corpus outcome is in contract
        assert got is not None, f"{label} dropped a file the scalar decodes"
        assert got.shape == ref.shape, (got.shape, ref.shape)
        if not got.size:
            continue
        if output == "f32":
            ref = np.clip(ref, -0.99999994, 0.99999994)
            assert np.abs(got - ref).max() <= 2e-6
        else:
            q = np.clip(np.rint(ref.astype(np.float64) * 32768.0),
                        -32768, 32767)
            assert np.abs(got.astype(np.int32) - q.astype(np.int32)).max() <= 2


def _corpus_trial(rng: np.random.Generator) -> str:
    """Randomized corpus composition through decode_corpus: mixed
    channels/rates/qualities (shared and distinct setups), a possibly
    corrupt member under on_error='none', and a small max_batch_bytes to
    force chunk splits/merges. Exercises the merge compiler, program
    signature unification, the dispatcher thread, and failure isolation —
    machinery the single-file shapes never touch. Contract per file:
    a None slot is acceptable only when the scalar decoder also rejects;
    when both produce PCM they must agree."""
    from vorbispizza_tpu.errors import VorbisError
    from vorbispizza_tpu.models.corpus import decode_corpus
    from vorbispizza_tpu.reader import VorbisReader

    import jax

    n = int(rng.integers(2, 6))
    sources = []
    for k in range(n):
        try:
            s = _random_stream(rng, serial=200 + k)
        except RuntimeError:
            continue
        if rng.random() < 0.25:
            s = _corrupt(rng, s)
        sources.append(s)
    if len(sources) < 2:
        return "skip"
    output = str(rng.choice(["s16", "f32"]))
    devices = None
    if rng.random() < 0.3:  # multi-device round-robin dispatch
        devs = jax.devices()
        if len(devs) >= 2:
            devices = devs[: int(rng.integers(2, len(devs) + 1))]
    outs = decode_corpus(
        sources, output=output, on_error="none",
        max_batch_bytes=int(rng.integers(1, 5)) << 20,
        devices=devices,
    )
    _verify_against_scalar(sources, outs, output, "corpus")
    return "ok"


def _sharded_trial(rng: np.random.Generator) -> str:
    """decode_corpus_sharded over a virtual stream mesh vs per-file
    scalar: exercises LPT balancing, signature unification across
    shards, psum wire folding, and the degradation ladder under the
    same randomized compositions as the corpus trial."""
    import jax
    from jax.sharding import Mesh

    from vorbispizza_tpu.errors import VorbisError
    from vorbispizza_tpu.parallel.corpus import decode_corpus_sharded
    from vorbispizza_tpu.reader import VorbisReader

    devs = jax.devices()
    if len(devs) < 2:
        return "skip"
    n_mesh = int(rng.choice([2, len(devs)]))
    mesh = Mesh(np.array(devs[:n_mesh]), axis_names=("stream",))
    sources = []
    for k in range(int(rng.integers(2, 6))):
        try:
            s = _random_stream(rng, serial=300 + k)
        except RuntimeError:
            continue
        if rng.random() < 0.2:
            s = _corrupt(rng, s)
        sources.append(s)
    if len(sources) < 2:
        return "skip"
    output = str(rng.choice(["s16", "f32"]))
    outs = decode_corpus_sharded(sources, mesh, output=output,
                                 on_error="none")
    _verify_against_scalar(sources, outs, output, "sharded corpus")
    return "ok"


#: default trial pool (weights = repetition)
SHAPES = ("single", "single", "corrupt", "corrupt", "corrupt",
          "chain", "mux", "chain_corrupt", "seek", "seek",
          "corpus", "corpus", "sharded")


def _one_trial(rng: np.random.Generator, shapes=SHAPES) -> str:
    """Returns 'ok' | 'skip' | 'reject'. Raises on contract violation."""
    from vorbispizza_tpu.errors import VorbisError
    from vorbispizza_tpu.frames import BatchUnsupported
    from vorbispizza_tpu.models.pipeline import decode_file_batch
    from vorbispizza_tpu.testing.encode import chain_streams, multiplex_streams

    shape = str(rng.choice(list(shapes)))
    if shape == "seek":
        return _seek_trial(rng)
    if shape == "corpus":
        return _corpus_trial(rng)
    if shape == "sharded":
        return _sharded_trial(rng)
    try:
        if shape in ("chain", "mux", "chain_corrupt"):
            parts = [_random_stream(rng, serial=100 + k)
                     for k in range(int(rng.integers(2, 4)))]
            data = (multiplex_streams(*parts) if shape == "mux"
                    else chain_streams(*parts))
            if shape == "chain_corrupt":
                data = _corrupt(rng, data)
        else:
            data = _random_stream(rng, serial=int(rng.integers(1, 2**31)))
            if shape == "corrupt":
                data = _corrupt(rng, data)
    except RuntimeError:
        return "skip"  # encoder rejected the config — not our surface

    try:
        ref = _decode_scalar(data)
    except VorbisError:
        ref = None  # loud rejection is within contract
    if shape == "mux":
        return "ok" if ref is not None else "reject"  # batch path is per-logical-stream

    try:
        got = decode_file_batch(data)
    except (VorbisError, BatchUnsupported):
        # batch may reject earlier than scalar; BatchUnsupported means the
        # batch compiler declined the stream — production decode_corpus
        # falls back to the scalar path for exactly this case
        return "reject" if ref is None else "ok"
    if ref is None:
        return "ok"  # scalar rejected, batch found a decodable prefix
    want = ref[0]  # batch pipeline decodes the FIRST logical stream only
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size:
        err = float(np.abs(got - want).max())
        assert err <= 2e-6, f"batch/scalar diverge: {err}"
    return "ok"


def main() -> int:
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    if len(sys.argv) > 3:
        want = set(sys.argv[3].split(","))
        unknown = want - set(SHAPES)
        if unknown:
            raise SystemExit(f"unknown shapes: {sorted(unknown)}")
        shapes = tuple(s for s in SHAPES if s in want)
    else:
        shapes = SHAPES
    _force_cpu()
    t0 = time.time()
    stats = {"ok": 0, "skip": 0, "reject": 0, "fail": 0, "slow": 0}
    trial = 0
    shape_arg = f" {sys.argv[3]}" if len(sys.argv) > 3 else ""
    while time.time() - t0 < budget:
        seed = seed0 + trial
        rng = np.random.default_rng(seed)
        t1 = time.time()
        try:
            stats[_one_trial(rng, shapes)] += 1
        except Exception:
            stats["fail"] += 1
            # repro must carry the SAME shape filter: the pool size
            # changes how the seed's rng draws map to a trial
            print(f"FAIL seed={seed} (repro: tools.fuzz 1 {seed}{shape_arg})",
                  flush=True)
            traceback.print_exc()
        dt = time.time() - t1
        if dt > _SLOW_S:
            stats["slow"] += 1
            print(f"SLOW seed={seed} took {dt:.1f}s", flush=True)
        trial += 1
        if trial % 25 == 0:
            # every composition traces a fresh program family; an
            # unbounded per-process jit cache OOM-killed a 2 h soak
            # (LLVM "Cannot allocate memory" -> SIGSEGV). Disk-cached
            # programs reload cheaply, so drop the in-memory set.
            import jax

            jax.clear_caches()
        if trial % 50 == 0:
            print(f"fuzz progress: {trial} trials: {stats}", flush=True)
    print(f"fuzz: {trial} trials in {time.time()-t0:.0f}s: {stats}")
    return 1 if stats["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
