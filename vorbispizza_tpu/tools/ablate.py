"""On-chip stage ablation of the fused decode program.

Times the full fused s16d program on a merged corpus chunk, then re-times
variants with one stage each snapped out (pack, quantize, OLA assembly,
synthesis math, symbol residue expansion) by monkeypatching the module
functions the traced body closes over. Differences against the baseline
attribute the exec-only budget per stage.

Each variant is its own XLA program (first run compiles; the persistent
jit cache (utils/cache.py) keeps them). Timings end in a real 4-byte
device->host pull.

Usage: python -m vorbispizza_tpu.tools.ablate [n_files] [secs_per_file]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _patched(monkey: dict):
    """Context manager: temporarily replace attributes given as
    {(obj, name): replacement}."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        saved = {}
        for (obj, name), repl in monkey.items():
            saved[(obj, name)] = getattr(obj, name)
            setattr(obj, name, repl)
        try:
            yield
        finally:
            for (obj, name), orig in saved.items():
                setattr(obj, name, orig)

    return cm()


def run_ablation(
    n_files: int = 8, secs: float = 15.0, reps: int = 5, channels: int = 2
):
    from ..models import pipeline as pl
    from ..models.corpus import _front_end, merge_streams
    from ..models.pipeline import BatchSynthesizer
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

    from ..ops import pcm_pack as pp

    def slice_ola(flat, evs, L, W=8):
        # stand-in with the right shape; the event arrays go dead and XLA
        # DCEs the whole block-index expansion with them
        return jnp.pad(flat, ((0, 0), (0, L)))[:, :L]

    # -- pack sub-stage stand-ins (attribute pack's 50 ms internally) -----

    def d2_only_select(q):
        # d2 candidate only: the d3/inter candidate search (3 extra diff+
        # zigzag+max passes and the where-accumulation select) goes dead
        C, L = q.shape
        NB = -(-L // pp.BLOCK)
        pad = NB * pp.BLOCK - L
        d1 = jnp.diff(q, axis=1, prepend=jnp.zeros((C, 1), q.dtype))
        d2 = jnp.diff(d1, axis=1, prepend=jnp.zeros((C, 1), d1.dtype))
        z = ((d2 << 1) ^ (d2 >> 31)).astype(jnp.uint32)
        if pad:
            z = jnp.pad(z, ((0, 0), (0, pad)))
        blk = z.reshape(C * NB, pp.BLOCK)
        m = blk.max(axis=1)
        wi = jnp.zeros(m.shape[0], dtype=jnp.int32)
        for w in pp.WIDTHS[:-1]:
            wi = wi + (m > ((1 << w) - 1)).astype(jnp.int32)
        # width-mode only: no rice flags, an all-zero unary plan
        return blk, wi, jnp.zeros_like(wi), jnp.zeros(blk.shape, jnp.int32)

    def zero_mm(blk):
        # bit expansion + selection matmul go dead (zeros uses only the
        # static shape); widx and compaction stay live
        _, offs, _ = pp._selection_matrix16()
        return jnp.zeros((blk.shape[0], int(offs[-1])), jnp.int32)

    def no_gather_compact(allbytes, widx, cap_groups=None):
        # static slice instead of the flat row-take gather; nbytes math
        # (take+cumsum over widx) stays live so only the gather is removed
        groups_tbl = jnp.asarray(
            np.asarray([4 * wd // 16 for wd in pp.WORDS], dtype=np.int32)
        )
        gpb = jnp.take(groups_tbl, widx)
        cap = cap_groups if cap_groups is not None else allbytes.shape[0] * pp.G_PER
        packed = (jnp.zeros(cap * 16, jnp.int32) + allbytes[0, 0]).astype(
            jnp.uint8
        )
        return packed, (jnp.sum(gpb) * 16).astype(jnp.int32)

    def flat_synth(self, key, residues, prime, final, floor_inputs, metas):
        return jnp.concatenate([residues, residues], axis=-1)

    orig_expand = pl.expand_submap

    def zero_expand(*a, **k):
        # zeros_like uses only the static shape: the original expansion's
        # value goes dead and XLA DCEs the whole symbol decode
        return jnp.zeros_like(orig_expand(*a, **k))

    variants = [
        ("full_s16d", "s16d", {}),
        ("no_pack(s16)", "s16", {}),
        ("no_quant(f32)", "f32", {}),
        ("pack_d2_only", "s16d", {(pp, "select_candidate"): d2_only_select}),
        ("pack_no_mm", "s16d", {(pp, "words_matmul"): zero_mm}),
        ("pack_no_gather", "s16d", {(pp, "compact"): no_gather_compact}),
        ("no_ola", "s16d", {(pl, "block_assemble_wide"): slice_ola}),
        ("no_synth_math", "s16d", {(BatchSynthesizer, "_synth_math"): flat_synth}),
        ("no_res_expand", "s16d", {(pl, "expand_submap"): zero_expand}),
        (
            "takes_only",
            "s16",
            {
                (pl, "block_assemble_wide"): slice_ola,
                (BatchSynthesizer, "_synth_math"): flat_synth,
                (pl, "expand_submap"): zero_expand,
            },
        ),
    ]

    results = {}
    base = None
    for name, output, monkey in variants:
        synth = BatchSynthesizer(setup, channels)
        with _patched(monkey):
            t_c0 = time.perf_counter()
            sig, args, total = synth.prepare(plan, buckets, output)
            out = synth.run(sig, args, total)
            probe = out[1] if isinstance(out, tuple) else out
            np.asarray(probe.ravel()[:4])  # warm + drain
            compile_s = time.perf_counter() - t_c0
            t0 = time.perf_counter()
            for _ in range(reps):
                out = synth.run(sig, args, total)
            probe = out[1] if isinstance(out, tuple) else out
            np.asarray(probe.ravel()[:4])
            per = (time.perf_counter() - t0) / reps
        results[name] = per
        if base is None:
            base = per
        delta = base - per
        print(
            f"{name:16s} {per * 1e3:9.1f} ms/chunk  rtf {audio_s / per:8.1f}"
            f"  delta_vs_full {delta * 1e3:8.1f} ms  (compile+warm {compile_s:.1f}s)",
            flush=True,
        )
    print(f"audio per chunk: {audio_s:.1f}s; reps={reps}")
    return results


if __name__ == "__main__":
    from ..utils.cache import configure as _configure_cache

    _configure_cache(jax)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    s = float(sys.argv[2]) if len(sys.argv) > 2 else 15.0
    ch = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    run_ablation(n, s, channels=ch)
