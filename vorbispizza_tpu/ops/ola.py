"""Overlap-add assembly as a gather (JAX/XLA).

The reference laps adjacent frames serially
(NVorbis/StreamDecoder.cs:764 OverlapBuffers). Frame supports tile the
output contiguously and at most TWO windowed frames cover any PCM sample
(the lapping pair; long->short transitions meet exactly at the boundary), so
instead of scatter-adding frames into an accumulator every output sample
*gathers* its one or two contributions:

    pcm[i] = flat[a_idx[i]] + (b_valid[i] ? flat[b_idx[i]] : 0)

where ``flat`` is all windowed frames flattened. The production formulation
is block_assemble(): the per-sample index arrays are piecewise i+const, so
whole W-sample blocks are affine slices of flat — expanded from
host-precomputed events at BLOCK granularity (phase-selected row takes +
event-coverage replacement), never materializing per-sample indices.
gather_assemble() below is the per-sample fallback formulation kept for
reference/tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..frames import BatchUnsupported


class OlaUnsupported(BatchUnsupported):
    """Overlap geometry the batch OLA cannot model (non-ascending frame
    supports, >2-deep coverage). Subclasses BatchUnsupported so callers of
    the batch pipeline need a single fallback exception."""


#: phase-decomposition width of block_assemble: W-sample output blocks are
#: affine slices of flat between events, so the bulk gather runs at 1/W of
#: the per-sample index count (row takes of [Tf/W, W]). Its W-way phase
#: select is O(L*W), so it wants a small W; block_assemble_wide below
#: supersedes it in production.
PHASE_W = 8

#: production width of block_assemble_wide. Chosen by a sweep on the
#: earlier accelerator and not re-measured on the GPU
#: (vorbispizza_tpu/tools/olasweep.py re-sweeps it).
WIDE_W = 128


def expand_assemble(flat, evs, L):
    """Per-sample reference formulation (tests / CPU fallback): expand the
    index/validity arrays from events with unit scatters + full-length
    cumsums, then gather_assemble. block_assemble_wide is the production
    path."""
    ev_j, ev_da, ev_db, ev_va, ev_vb = evs
    ones = jnp.ones(L, jnp.int32)
    zero = jnp.zeros(L, jnp.int32)
    a_idx = jnp.cumsum(ones.at[ev_j].add(ev_da, mode="drop")) - 1
    b_idx = jnp.cumsum(ones.at[ev_j].add(ev_db, mode="drop")) - 1
    a_valid = jnp.cumsum(zero.at[ev_j].add(ev_va, mode="drop")) > 0
    b_valid = jnp.cumsum(zero.at[ev_j].add(ev_vb, mode="drop")) > 0
    return gather_assemble(flat, a_idx, a_valid, b_idx, b_valid)


def _check_w(W: int, L: int) -> None:
    # the >>log2(W) / &(W-1) row-phase arithmetic REQUIRES a power-of-two
    # W that divides L; W is process-wide retunable, so fail loudly
    # instead of producing silently wrong PCM (a raise, not an assert:
    # it must survive python -O)
    if W <= 0 or (W & (W - 1)) != 0:
        raise ValueError(f"W must be a power of two, got {W}")
    if L % W != 0:
        raise ValueError(f"L={L} not a multiple of W={W}")


def _event_geometry(flat, evs, L, W):
    """Shared prelude of both block formulations: per-event block/offset
    coordinates, the [Ep, W] coverage mask (event k covers [off_k,
    o_next_k) within its block; events arrive j-sorted), and flat viewed
    as W-wide rows with one zero row appended (OOB row takes fill 0).
    Padding events carry j = L -> blk = NB; scatters drop them."""
    ev_j = evs[0]
    C, Tf = flat.shape
    NB = L // W
    blk = ev_j // W
    off = ev_j - blk * W
    tw = jnp.arange(W, dtype=jnp.int32)
    nxt_same = jnp.concatenate([blk[1:] == blk[:-1], jnp.zeros(1, dtype=bool)])
    o_next = jnp.where(nxt_same, jnp.concatenate([off[1:], off[:1]]), jnp.int32(W))
    emask = (
        (tw[None, :] >= off[:, None]) & (tw[None, :] < o_next[:, None])
    ).astype(jnp.float32)  # [Ep, W]
    TfR = -(-(Tf + 1) // W)
    flat_r = jnp.pad(flat, ((0, 0), (0, TfR * W - Tf))).reshape(C, TfR, W)
    return C, NB, blk, tw, emask, flat_r


def _block_levels(blk, dv, vv, NB, W):
    """Per-block chain state at t=0: exclusive prefix over per-block event
    totals gives the side's gather start index and validity for the bulk
    (start may be negative in invalid regions; validity zeroes whatever
    the clamped take returns)."""
    d_tot = jnp.zeros(NB, jnp.int32).at[blk].add(dv, mode="drop")
    d_pre = jnp.cumsum(d_tot) - d_tot
    v_tot = jnp.zeros(NB, jnp.int32).at[blk].add(vv, mode="drop")
    v_pre = jnp.cumsum(v_tot) - v_tot
    start = jnp.arange(NB, dtype=jnp.int32) * W + d_pre  # a_idx at t=0
    bval = (v_pre > 0).astype(jnp.float32)
    return start, bval


def block_assemble(flat, evs, L, W: int | None = None):
    """Phase-decomposed OLA assembly, bit-identical to expand_assemble.

    ``W`` defaults to the module-level PHASE_W at CALL time (late-bound:
    a sweep or deployment can retune ola.PHASE_W process-wide without
    touching call sites; programs are retraced per W).

    Between host events (models/pipeline.py _build_events) the gather
    index advances exactly +1/sample and validity is constant, so every
    W-sample output block is an affine slice of ``flat``. The bulk of the
    output is built with TWO row-takes per side over flat viewed as
    [Tf/W, W] rows (consecutive rows r, r+1 at the block's start index,
    selected by the start's phase) — 1/W the index count of the
    per-sample formulation (expand_assemble).

    Samples in blocks that contain events are REPLACED, not corrected:
    event k covers [o_k, o_next) within its block, where o_next is the
    next event's offset when it lands in the same block, else W (events
    arrive j-SORTED — prepare_host sorts). For covered samples the
    per-side chain state after event k is simply m_k(t) = blk*W + t +
    inclusive-cumsum(d)[k] and v_k = inclusive-cumsum(v)[k] > 0 (the
    sorted stream makes the global cumsum the per-sample prefix). Their
    value v_k*flat[m_k] scatter-adds onto a base whose bulk was zeroed by
    the coverage mask, so every output sample is one 0/1-product
    selection per side plus the same final side-add as gather_assemble —
    bit-identical to expand_assemble under ANY block decomposition
    (shard-local geometry included). Duplicate-j events compose exactly:
    the earlier one's coverage is empty and the later carries the
    combined deltas.

    A third formulation — per-block contiguous dynamic slices — measured
    slower than even expand_assemble on the earlier accelerator, where
    XLA lowered unaligned slice gathers to per-slice code; not
    re-measured on the GPU.

    evs: (ev_j, ev_da, ev_db, ev_va, ev_vb) i32 arrays, sorted by ev_j;
    padding events carry j = L, whose columns >= L every scatter drops.
    """
    if W is None:
        W = PHASE_W
    _check_w(W, L)
    _, ev_da, ev_db, ev_va, ev_vb = evs
    C, NB, blk, tw, emask, flat_r = _event_geometry(flat, evs, L, W)
    cols = ((blk * W)[:, None] + tw[None, :]).reshape(-1)  # event columns
    # keep = 1 where no event covers the sample (coverages are disjoint)
    keep = (
        1.0
        - jnp.zeros(L, jnp.float32).at[cols].add(
            emask.reshape(-1), mode="drop"
        )
    )[None, :]

    def side(dv, vv):
        start, bval = _block_levels(blk, dv, vv, NB, W)
        # bulk: rows r, r+1 lane-selected by phase (this formulation's
        # W-way where chain; block_assemble_wide uses the barrel shifter)
        r = start >> int(np.log2(W))  # arithmetic shift: floor for negatives
        ph = start & (W - 1)
        rowa = jnp.take(flat_r, r, axis=1, mode="fill", fill_value=0.0)
        rowb = jnp.take(flat_r, r + 1, axis=1, mode="fill", fill_value=0.0)
        cat = jnp.concatenate([rowa, rowb], axis=-1)  # [C, NB, 2W]
        approx = jnp.zeros((C, NB, W), jnp.float32)
        for p in range(W):
            approx = jnp.where(
                (ph == p)[None, :, None], cat[:, :, p : p + W], approx
            )
        approx = approx * bval[None, :, None]
        # covered samples: chain state after event k from the global
        # inclusive cumsum of the j-sorted stream
        m_cur = (blk * W + jnp.cumsum(dv))[:, None] + tw[None, :]  # [Ep, W]
        v_cur = (jnp.cumsum(vv) > 0).astype(jnp.float32)[:, None]
        f_cur = jnp.take(flat, m_cur, axis=1, mode="fill", fill_value=0.0)
        vals = f_cur * (v_cur * emask)  # [C, Ep, W] exact 0/1 selection
        base = approx.reshape(C, L) * keep
        return base.at[:, cols].add(vals.reshape(C, -1), mode="drop")

    # the final side-add matches gather_assemble's `a + b` bit-for-bit
    return side(ev_da, ev_va) + side(ev_db, ev_vb)


def _row_phase_take(flat_r, start, W):
    """[C, K, W] windows flat.flat[start[k] : start[k]+W] with OOB -> 0.

    Two consecutive row takes of the [C, TfR, W] row view + a barrel-shift
    lane rotation (log2(W) masked rolls instead of block_assemble's W-way
    where chain): at W=128 the roll count is 7, so the per-window cost is
    O(log W) selects over W-wide rows instead of O(W). start may be
    negative (invalid regions): arithmetic >> floors, & gives the phase,
    and the OOB row fill returns zeros exactly like a per-sample
    mode="fill" take."""
    r = start >> int(np.log2(W))
    ph = start & (W - 1)
    rowa = jnp.take(flat_r, r, axis=1, mode="fill", fill_value=0.0)
    rowb = jnp.take(flat_r, r + 1, axis=1, mode="fill", fill_value=0.0)
    x = jnp.concatenate([rowa, rowb], axis=-1)  # [C, K, 2W]
    # rotate left by ph: positions [0, W) read original [ph, ph+W) and
    # ph+W <= 2W, so wrapped lanes never land in the kept window
    for b in range(int(np.log2(W))):
        s = 1 << b
        x = jnp.where(((ph >> b) & 1)[None, :, None] != 0, jnp.roll(x, -s, axis=-1), x)
    return x[:, :, :W]


def block_assemble_wide(flat, evs, L, W: int | None = None):
    """Row-granularity OLA assembly, bit-identical to expand_assemble /
    block_assemble (same events contract, any power-of-two W dividing L).

    Differences vs block_assemble, all aimed at large W (such as
    WIDE_W): (1) the bulk phase selection is the barrel shifter of
    _row_phase_take (O(log W) masked rolls, not W wheres); (2) the event
    windows f_cur are ALSO row takes + barrel shift (block_assemble
    gathers Ep*W per-sample indices — at W=128 that alone rivals the
    per-sample formulation); (3) coverage zeroing and the event
    scatter-add are ROW scatters at [NB/Ep, W] granularity instead of
    element scatters over Ep*W flat columns."""
    if W is None:
        W = WIDE_W
    _check_w(W, L)
    _, ev_da, ev_db, ev_va, ev_vb = evs
    C, NB, blk, _tw, emask, flat_r = _event_geometry(flat, evs, L, W)
    # padding events carry j = L -> blk = NB: row scatters drop them
    keep = 1.0 - jnp.zeros((NB, W), jnp.float32).at[blk].add(emask, mode="drop")

    def side(dv, vv):
        start, bval = _block_levels(blk, dv, vv, NB, W)
        approx = _row_phase_take(flat_r, start, W) * bval[None, :, None]
        start_e = blk * W + jnp.cumsum(dv)  # event-window starts [Ep]
        v_cur = (jnp.cumsum(vv) > 0).astype(jnp.float32)[:, None]
        f_cur = _row_phase_take(flat_r, start_e, W)
        vals = f_cur * (v_cur * emask)  # [C, Ep, W]
        base = approx * keep[None, :, :]
        return base.at[:, blk].add(vals, mode="drop").reshape(C, L)

    return side(ev_da, ev_va) + side(ev_db, ev_vb)


def gather_assemble(flat, a_idx, a_valid, b_idx, b_valid):
    """Device side: pcm[c, i] = flat[c, a_idx[i]]*a_valid + flat[c, b_idx[i]]*b_valid.

    Out-of-bounds indices (possible on masked/padding positions) gather 0
    explicitly — the default NaN fill would rely on the mask multiply
    lowering to a select."""
    a = jnp.take(flat, a_idx, axis=1, mode="fill", fill_value=0.0) * a_valid
    b = jnp.take(flat, b_idx, axis=1, mode="fill", fill_value=0.0) * b_valid
    return a + b


def overlap_add(out, frames, offsets):
    """Scatter-add reference implementation (tests only — slow under XLA).

    out: [C, total]; frames: [F, C, n]; offsets: [F] (may be negative =
    partially out of range; those samples are dropped)."""
    n = frames.shape[-1]
    total = out.shape[-1]
    idx = offsets[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :]  # [F, n]
    # JAX's mode="drop" only drops indices >= total; negatives would WRAP.
    idx = jnp.where(idx < 0, total, idx)
    flat = frames.transpose(1, 0, 2).reshape(frames.shape[1], -1)  # [C, F*n]
    return out.at[:, idx.reshape(-1)].add(flat, mode="drop", unique_indices=False)
