"""On-chip sweep of the OLA assembly's phase width W (ops/ola.py).

Usage: python -m vorbispizza_tpu.tools.olasweep [n_files] [secs] [channels]
(channels=6 sweeps the 5.1 case)
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _time_exec(synth, plan, buckets, output, reps=5):
    sig, args, total = synth.prepare(plan, buckets, output)
    t_c0 = time.perf_counter()
    out = synth.run(sig, args, total)
    probe = out[1] if isinstance(out, tuple) else out
    np.asarray(probe.ravel()[:4])
    compile_s = time.perf_counter() - t_c0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = synth.run(sig, args, total)
    probe = out[1] if isinstance(out, tuple) else out
    np.asarray(probe.ravel()[:4])
    return (time.perf_counter() - t0) / reps, compile_s


def run_sweep(
    n_files: int = 8,
    secs: float = 15.0,
    channels: int = 2,
    forms: str = "both",
):
    from ..models import pipeline as pl
    from ..models.corpus import _front_end, merge_streams
    from ..models.pipeline import BatchSynthesizer
    from ..ops import ola
    from ..testing.encode import encode_vorbis, make_signal

    rate = 44100
    corpus = [
        encode_vorbis(
            make_signal(channels, secs, rate=rate, kind="music", seed=s),
            rate=rate,
            quality=0.4,
        )
        for s in range(n_files)
    ]
    fronts = [_front_end(c) for c in corpus]
    setup, channels = fronts[0][0], fronts[0][1]
    plan, buckets, lens = merge_streams([f[2:4] for f in fronts])
    audio_s = sum(lens) / rate

    ref = None
    for form, Ws in (
        ("block", (8, 16, 32, 64, 128)),
        ("wide", (8, 32, 64, 128, 256)),
    ):
        if forms not in ("both", form):
            continue
        fn = ola.block_assemble if form == "block" else ola.block_assemble_wide
        for W in Ws:
            def wth(flat, evs, L, _W=W, _fn=fn):
                return _fn(flat, evs, L, W=_W)

            saved = pl.block_assemble_wide
            pl.block_assemble_wide = wth
            try:
                synth = BatchSynthesizer(setup, channels)
                per, compile_s = _time_exec(synth, plan, buckets, "f32")
                sig, args, total = synth.prepare(plan, buckets, "f32")
                outw = np.asarray(synth.run(sig, args, total))
                if ref is None:
                    ref = outw
                exact = bool(np.array_equal(outw, ref))
                print(
                    f"{form:5s} W={W:3d}  {per * 1e3:8.1f} ms/chunk"
                    f"  rtf {audio_s / per:8.1f}"
                    f"  bitexact {exact}  (compile {compile_s:.1f}s)",
                    flush=True,
                )
            finally:
                pl.block_assemble_wide = saved


if __name__ == "__main__":
    from ..utils.cache import configure as _configure_cache

    _configure_cache(jax)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    s = float(sys.argv[2]) if len(sys.argv) > 2 else 15.0
    ch = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    fo = sys.argv[4] if len(sys.argv) > 4 else "both"
    run_sweep(n, s, ch, fo)
