"""Headline benchmark: corpus decode throughput on the attached GPU.

Measures:
  1. headline  — 32x15s stereo 44.1 kHz corpus -> host s16 (the BASELINE
     "batched corpus" config), median of 5 reps with min/max spread,
     stage breakdown (DecodeTimer) and h2d/d2h byte counts;
  2. device execution in isolation (no transfers in the timed loop);
  3. 5.1 multichannel (Residue2 + coupling, BASELINE config #3), with its
     own exec-only metric;
  4. device-resident mode (PCM stays in device memory);
  5. one file (``--single-file``; without it the synthesized corpus[0],
     which the run says loudly);
  6. chained streams + seeking (BASELINE config #4).

Accuracy is asserted against the float64 scalar anchor each run.

Requires a GPU (exits with a message otherwise) and names the card it ran
on. Progress goes to stderr; stdout carries ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

_T0 = time.perf_counter()

RESULTS = {
    "metric": "decode_rtf_corpus",
    "value": -2.0,
    "unit": "x_realtime_per_card",
    "vs_baseline": -0.002,
    "value_min": -2.0,
    "value_max": -2.0,
    "value_reps": 0,
    "rtf_device_resident": -2.0,
    "rtf_single_file": -2.0,
    "single_file_source": "",
    "rtf_device_exec_only": -2.0,
    "rtf_multichannel_5_1": -2.0,
    "rtf_exec_5_1": -2.0,
    "chained_seek_ms": -2.0,
    "stages_s": {},
    "h2d_mb": -2.0,
    "d2h_mb": -2.0,
    "max_abs_err_vs_anchor": -2.0,
    "s16_err_5_1_lsb": 0,
    "corpus_streams": 0,
    "corpus_audio_seconds": 0.0,
    "device": {},
    "card": [],
    "bench_wall_s": -2.0,
}


def _mark(msg: str) -> None:
    """Progress to stderr (stdout carries only the JSON line)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="corpus decode benchmark")
    ap.add_argument(
        "--single-file",
        help="Ogg Vorbis file for the single-file metric (BASELINE config "
        "#1 is the reference's TestFiles/1test.ogg)",
    )
    args = ap.parse_args(argv)

    import jax

    from vorbispizza_tpu.utils.device import card_names, require_gpu

    dev = require_gpu(jax, "bench")
    RESULTS["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    RESULTS["card"] = card_names()
    _mark(f"device {dev.device_kind}: {RESULTS['card']}")

    from vorbispizza_tpu.utils.cache import configure as _configure_cache

    _configure_cache(jax)

    from vorbispizza_tpu.models.corpus import (
        _front_end,
        _synthesizer_for,
        decode_corpus,
        merge_streams,
    )
    from vorbispizza_tpu.reader import VorbisReader
    from vorbispizza_tpu.testing.encode import (
        chain_streams,
        encode_vorbis,
        make_signal,
    )
    from vorbispizza_tpu.utils.profiling import DecodeTimer

    _mark("encoding corpus")
    rate = 44100
    n_streams = 32
    seconds = 15.0
    corpus = [
        encode_vorbis(
            make_signal(2, seconds, rate=rate, kind="music", seed=seed),
            rate=rate,
            quality=0.5,
        )
        for seed in range(n_streams)
    ]
    total_audio = n_streams * seconds
    RESULTS["corpus_streams"] = n_streams
    RESULTS["corpus_audio_seconds"] = round(total_audio, 1)

    _mark("encoding 5.1 corpus")
    corpus51 = [
        encode_vorbis(
            make_signal(6, 10.0, rate=rate, kind="music", seed=100 + s),
            rate=rate,
            quality=0.4,
        )
        for s in range(4)
    ]

    # ---- accuracy vs the float64 scalar anchor ---------------------------------
    _mark("accuracy check (first compile)")
    r = VorbisReader(corpus[0])
    r.initialize()
    ref = r.read_all(planar=True)
    outs = decode_corpus(corpus[:1])
    max_err = float(np.abs(outs[0] - ref).max())
    RESULTS["max_abs_err_vs_anchor"] = max_err

    # ---- headline: corpus -> host s16, stage-attributed, median-of-reps --------
    _mark("headline warm (compile)")
    decode_corpus(corpus, output="s16")  # warm (compile)
    _mark("headline timed reps")
    rep_rtfs = []
    timer = DecodeTimer()
    reps = 5
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_corpus(corpus, output="s16", timer=timer)
        rep_rtfs.append(total_audio / (time.perf_counter() - t0))
    RESULTS["value"] = round(float(np.median(rep_rtfs)), 2)
    RESULTS["value_min"] = round(min(rep_rtfs), 2)
    RESULTS["value_max"] = round(max(rep_rtfs), 2)
    RESULTS["value_reps"] = reps
    RESULTS["vs_baseline"] = round(RESULTS["value"] / 1000.0, 4)
    RESULTS["stages_s"] = {k: round(v / reps, 3) for k, v in timer.stages.items()}
    RESULTS["h2d_mb"] = round(timer.counters.get("h2d_bytes", 0) / reps / 1e6, 1)
    RESULTS["d2h_mb"] = round(timer.counters.get("d2h_bytes", 0) / reps / 1e6, 1)

    # ---- device execution in isolation (no transfers in the timed loop) --------
    # prepare (h2d) once, then loop the fused program
    _mark("device exec only")
    fronts = [_front_end(c) for c in corpus[:8]]
    synth_x = _synthesizer_for(fronts[0][0], fronts[0][1])
    plan_x, buckets_x, lens_x = merge_streams([f[2:4] for f in fronts])
    args_x = synth_x.prepare(plan_x, buckets_x, "s16d")
    synth_x.run(*args_x)[1].block_until_ready()  # warm
    audio_x = sum(lens_x) / rate
    reps_x = 5
    t0 = time.perf_counter()
    for _ in range(reps_x):
        out_x = synth_x.run(*args_x)
    out_x[1].block_until_ready()
    RESULTS["rtf_device_exec_only"] = round(
        reps_x * audio_x / (time.perf_counter() - t0), 2
    )

    # ---- 5.1 multichannel (Residue2 + coupling) ---------------------------------
    _mark("5.1 multichannel")
    r51 = VorbisReader(corpus51[0])
    r51.initialize()
    ref51 = r51.read_all(planar=True)
    outs51 = decode_corpus(corpus51, output="s16")  # warm + shapes
    q51 = np.clip(np.rint(ref51.astype(np.float64) * 32768.0), -32768, 32767)
    RESULTS["s16_err_5_1_lsb"] = int(
        np.abs(outs51[0].astype(np.int64) - q51.astype(np.int64)).max()
    )
    t0 = time.perf_counter()
    decode_corpus(corpus51, output="s16")
    RESULTS["rtf_multichannel_5_1"] = round(
        (4 * 10.0) / (time.perf_counter() - t0), 2
    )
    fronts51 = [_front_end(c) for c in corpus51]
    synth51 = _synthesizer_for(fronts51[0][0], fronts51[0][1])
    plan51, buckets51, lens51 = merge_streams([f[2:4] for f in fronts51])
    a51 = synth51.prepare(plan51, buckets51, "s16d")
    synth51.run(*a51)[1].block_until_ready()  # warm
    t0 = time.perf_counter()
    for _ in range(5):
        o51 = synth51.run(*a51)
    o51[1].block_until_ready()
    RESULTS["rtf_exec_5_1"] = round(
        5 * sum(lens51) / rate / (time.perf_counter() - t0), 2
    )

    # ---- device-resident (no PCM pull) ---------------------------------------------
    _mark("device-resident mode")

    def rtf_device():
        jax.block_until_ready(decode_corpus(corpus, output="device"))

    rtf_device()  # warm
    t0 = time.perf_counter()
    rtf_device()
    RESULTS["rtf_device_resident"] = round(
        total_audio / (time.perf_counter() - t0), 2
    )

    # ---- single stereo file (BASELINE config #1: TestFiles/1test.ogg) ----------
    _mark("single file")
    if args.single_file:
        with open(args.single_file, "rb") as f:
            single = f.read()
        RESULTS["single_file_source"] = args.single_file
    else:
        _mark(
            "single file: no --single-file given, so the metric decodes the "
            "synthesized corpus[0] (15 s stereo), not BASELINE's 1test.ogg"
        )
        single = corpus[0]
        RESULTS["single_file_source"] = "synthesized corpus[0]"
    outs1 = decode_corpus([single], output="s16")  # warm
    single_seconds = outs1[0].shape[1] / rate
    t0 = time.perf_counter()
    decode_corpus([single], output="s16")
    RESULTS["rtf_single_file"] = round(
        single_seconds / (time.perf_counter() - t0), 2
    )

    # ---- chained + seek ----------------------------------------------------------
    _mark("chained + seek")
    a = encode_vorbis(make_signal(2, 8.0, rate=rate, kind="music", seed=200),
                      rate=rate, quality=0.4, serial=1)
    b = encode_vorbis(make_signal(2, 8.0, rate=rate, kind="music", seed=201),
                      rate=rate, quality=0.4, serial=2)
    chained = chain_streams(a, b)
    rd = VorbisReader(chained, accelerated=True)
    rd.initialize()
    rd.read_samples(1024)  # warm (full batch decode happens here)
    rng = np.random.default_rng(0)
    positions = rng.integers(0, rd.total_samples - 4096, size=64)
    t0 = time.perf_counter()
    for p in positions:
        rd.seek_to(int(p))
        rd.read_samples(1024)
    RESULTS["chained_seek_ms"] = round(
        (time.perf_counter() - t0) / len(positions) * 1e3, 2
    )

    # Accuracy gates BEFORE the JSON goes out: a build that blows the
    # anchor budget must not publish a harvestable RTF. value=-3.0 is the
    # "fast but wrong" sentinel, distinct from -2.0 (never measured).
    err51 = RESULTS["s16_err_5_1_lsb"]
    failures = []
    if max_err > 1e-6:
        failures.append(f"accuracy budget exceeded: {max_err}")
    if err51 > 1:
        failures.append(f"5.1 s16 error: {err51}")
    if failures:
        _mark("ACCURACY GATE FAILED: " + "; ".join(failures))
        RESULTS["value"] = -3.0
        RESULTS["vs_baseline"] = -0.003
    RESULTS["bench_wall_s"] = round(time.perf_counter() - _T0, 1)
    print(json.dumps(RESULTS), flush=True)
    if failures:
        raise SystemExit("; ".join(failures))


if __name__ == "__main__":
    main()
