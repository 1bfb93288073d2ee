"""Stream-data-parallel corpus decode: the PRODUCTION pipeline under
shard_map.

parallel/mesh.py demonstrates ('stream','frame') sharding on a uniform
synthesis step; THIS module runs the real thing — the full fused program of
models/pipeline.py (symbol-transport residue expansion, mixed blocksizes,
granule trims, event-based OLA, dpack PCM wire) — as ONE SPMD program over
a 1-D stream mesh. Each device decodes its own merged sub-chunk; streams
are independent so no halo is needed at stream seams (each stream's OLA is
segment-masked inside its shard), and a psum over the mesh folds each
shard's packed wire size into a global byte count (the collective the
deployment uses to size the host pull).

The precondition for SPMD is a SINGLE program signature across shards.
Shard contents differ (frame counts, nonzero residue blocks, symbol stream
lengths), so sigs are unified in two passes: prepare each shard with the
quantized padding, and if sigs still differ, re-prepare with the
elementwise MAXIMUM pads (pipeline.sig_pads/merge_pads) — padded rows are
zero frames, padded symbols are end-of-stream sentinels, padded events
scatter out of range, all no-ops by construction. Buckets missing from a
shard are filled with empty clones so every shard sees the same bucket
list. If sigs still disagree (different setups mid-group — impossible by
grouping), ShardMismatch tells the caller to fall back to per-device
dispatch.

The reference has no analog (SURVEY.md §2.9: no distributed runtime of any
kind); this is the framework's multi-device scale-out surface.
"""

from __future__ import annotations

import numpy as np

from ..decoder import CLIP_MAX
from ..frames import BucketBatch, FloorGroup, SymBucket

__all__ = [
    "ShardMismatch",
    "partition_indices",
    "sharded_chunk_run",
    "unpack_shard",
    "decode_corpus_sharded",
]


class ShardMismatch(Exception):
    """Shard program signatures could not be unified (callers fall back to
    per-device dispatch)."""


def _key_order(k):
    return (k.sid, k.mode_idx, bool(k.prev_flag), bool(k.next_flag))


def _empty_bucket(ref: BucketBatch) -> BucketBatch:
    """A zero-frame clone of ``ref`` (same key/floor/transport structure):
    shards missing a bucket key present elsewhere get one of these so every
    shard's bucket list — and therefore its program signature — lines up."""
    groups = []
    for g in ref.floor_groups:
        ng = FloorGroup(floor=g.floor, channels=list(g.channels))
        nc = len(g.channels)
        ng.used = np.zeros((0, nc), dtype=bool)
        if g.floor.floor_type == 1:
            ng.posts = np.zeros((0, nc, g.posts.shape[2]), g.posts.dtype)
            ng.step2 = np.zeros((0, nc, g.step2.shape[2]), g.step2.dtype)
            if g.ys is not None:
                # the clone must preserve ys availability or this shard
                # falls back to the posts wire while the others pick the
                # coded-ys wire -> ShardMismatch (fuzz seed 9003)
                ng.ys = np.zeros((0, nc, g.ys.shape[2]), g.ys.dtype)
        else:
            ng.coefficients = np.zeros(
                (0, nc, g.coefficients.shape[2]), g.coefficients.dtype
            )
            ng.amplitude = np.zeros((0, nc), g.amplitude.dtype)
        groups.append(ng)
    sym = None
    residues = None
    if ref.sym is not None:
        sym = SymBucket(
            layout=ref.sym.layout,
            groups=ref.sym.groups,
            syms=[np.zeros(0, s.dtype) for s in ref.sym.syms],
            slots=[np.zeros(0, s.dtype) for s in ref.sym.slots],
            part_counts=np.zeros(
                (0, ref.sym.part_counts.shape[1]), ref.sym.part_counts.dtype
            ),
        )
    elif ref.residues is not None:
        residues = np.zeros((0,) + ref.residues.shape[1:], ref.residues.dtype)
    return BucketBatch(
        key=ref.key,
        n=ref.n,
        frame_indices=np.zeros(0, ref.frame_indices.dtype),
        offsets=np.zeros(0, ref.offsets.dtype),
        prime=np.zeros(0, dtype=bool),
        final=np.zeros(0, dtype=bool),
        residues=residues,
        floor_groups=groups,
        sym=sym,
    )


def _empty_plan():
    from ..frames import FramePlan, FrameSoA

    z = np.zeros(0, dtype=np.int64)
    zb = np.zeros(0, dtype=bool)
    return FramePlan(
        frames=[],
        total_len=1,
        chains=[],
        chain_segments=[],
        buckets={},
        soa_cache=FrameSoA(z, z, z, z, z, zb, zb),
    )


def partition_indices(costs, n_shards: int):
    """Greedy longest-processing-time balance of stream indices into
    ``n_shards`` groups (indices stay sorted within a group so chunk
    composition is deterministic)."""
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in np.argsort(np.asarray(costs, dtype=np.int64))[::-1]:
        k = int(np.argmin(loads))
        shards[k].append(int(i))
        loads[k] += int(costs[i])
    return [sorted(s) for s in shards]


def _unify_buckets(merged):
    """Same sorted bucket list on every shard (empty clones for holes)."""
    ref_by_key = {}
    for _, bks, _ in merged:
        for b in bks:
            ref_by_key.setdefault(b.key, b)
    keys = sorted(ref_by_key, key=_key_order)
    blists = []
    for _, bks, _ in merged:
        by_key = {b.key: b for b in bks}
        blists.append(
            [by_key.get(k) or _empty_bucket(ref_by_key[k]) for k in keys]
        )
    return blists


def _sharded_fn(synth, sig, mesh, nargs: int):
    """jit(shard_map(fused body)) over the 1-D mesh, cached per (sig, mesh).
    The program returns (stacked outputs [n_shards, ...], global packed
    wire bytes via psum over the mesh)."""
    key = ("shard_map", sig, mesh)
    cached = synth._fns.get(key)
    if cached is not None:
        return cached
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    body = synth._fused_body(sig)
    axis = mesh.axis_names[0]

    def local(*args):
        out = body(*[a[0] for a in args])
        if sig[5] == "s16d":
            nb = jnp.sum(
                out[:4].astype(jnp.int32)
                << jnp.arange(0, 32, 8, dtype=jnp.int32)
            )
        else:
            nb = jnp.int32(0)
        wire_bytes = jax.lax.psum(nb, axis)
        return out[None], wire_bytes

    fn = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=tuple(P(axis) for _ in range(nargs)),
            out_specs=(P(axis), P()),
            check_vma=False,
        )
    )
    synth._fns[key] = fn
    return fn


def sharded_chunk_run(synth, shard_items, mesh, output: str = "s16d"):
    """Run one SPMD decode of ``shard_items`` (one list of (plan, buckets)
    per mesh device; empty lists allowed) on a 1-D mesh.

    Returns (sig, out, totals, lens_per_shard, wire_bytes): ``out`` is the
    stacked sharded output [n_shards, ...]; unpack each row with
    unpack_shard. ``wire_bytes`` is the psum-folded global packed size
    (0 for non-dpack outputs)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..models.corpus import merge_streams

    if len(mesh.axis_names) != 1:
        raise ShardMismatch("sharded_chunk_run needs a 1-D mesh")
    n_shards = int(np.prod(list(mesh.shape.values())))
    if len(shard_items) != n_shards:
        raise ShardMismatch(
            f"{len(shard_items)} shards for a {n_shards}-device mesh"
        )
    merged = [
        merge_streams(items) if items else (_empty_plan(), [], [])
        for items in shard_items
    ]
    blists = _unify_buckets(merged)
    preps = [
        synth.prepare_host(plan, bl, output, pads={})
        for (plan, _, _), bl in zip(merged, blists)
    ]
    sigs = [p[0] for p in preps]
    if len(set(sigs)) > 1:
        from ..models.pipeline import merge_pads

        pads = merge_pads(sigs)
        preps = [
            synth.prepare_host(plan, bl, output, pads=pads)
            for (plan, _, _), bl in zip(merged, blists)
        ]
        sigs = [p[0] for p in preps]
        if len(set(sigs)) > 1:
            raise ShardMismatch("shard sigs did not unify under max pads")
    sig = sigs[0]
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    stacked = [
        jax.device_put(np.stack([p[1][i] for p in preps]), sharding)
        for i in range(len(preps[0][1]))
    ]
    fn = _sharded_fn(synth, sig, mesh, len(stacked))
    out, wire_bytes = fn(*stacked)
    totals = [p[2] for p in preps]
    lens = [m[2] for m in merged]
    return sig, out, totals, lens, wire_bytes


def unpack_shard(row: np.ndarray, sig, channels: int, total: int):
    """One shard's raw output row -> host PCM [C, total] (int16 for dpack,
    else the row's dtype)."""
    output = sig[5]
    out_len = sig[3]
    if output in ("s16d", "s16df"):
        from ..ops.pcm_pack import (
            _check_sections,
            _parse_header,
            unpack_pcm,
            wire_header_bytes,
            wire_rows,
        )

        nbt = wire_rows(out_len, channels)
        HDR = wire_header_bytes(channels)
        h = np.asarray(row)
        nb, plane_cap, cuts, widx = _parse_header(h, nbt, channels)
        # exact per-section overflow detection (a truncated soft-cap
        # wire raises PackOverflow; caller re-runs "s16df")
        _check_sections(nb, plane_cap, cuts, widx, h.shape[0] - HDR - nbt)
        data = h[HDR + nbt : HDR + nbt + nb]
        return unpack_pcm(data, widx, channels, out_len, cuts)[:, :total]
    return np.asarray(row)[..., :total]


def decode_corpus_sharded(sources, mesh, *, output: str = "s16", on_error: str = "raise"):
    """Decode a corpus with stream-level data parallelism over ``mesh``
    (1-D). Groups streams by channel count (setups may differ — bucket
    keys carry setup identity), partitions each group over the mesh
    devices (balanced by frame count), and runs ONE shard_map program per
    group. Falls back per stream to the scalar decoder for shapes the batch
    planner rejects, and per group to single-device dispatch on
    ShardMismatch. Returns PCM arrays in input order.

    ``output``:
      "s16"    — host int16 [C, samples] (dpack wire, device quantize)
      "f32"    — host float32 [C, samples], clipped
      "device" — per-stream jax f32 views into each shard's device-resident
                 output (matching
                 single-device decode_corpus(output="device"): PCM stays
                 on the device that decoded it for downstream consumers —
                 feature extraction, ASR, ...). Unclipped, like the
                 single-device tier.

    ``on_error``: "raise" (default) propagates a malformed source's
    VorbisError; "none" leaves the failed file's slot as None and decodes
    the rest (same contract as decode_corpus).

    Degradation note: a stream the batch planner rejects falls back to the
    float64 scalar decoder, whose s16 quantization can differ from the
    device-f32 batch path by ±1 LSB — a partially-degraded corpus is
    correct but not bit-stable across runs that degrade differently
    (tests/test_parallel.py pins the ≤1 LSB bound)."""
    from ..errors import VorbisError
    from ..frames import BatchUnsupported
    from ..models.corpus import (
        _front_end,
        _scalar_fallback,
        _synthesizer_for,
    )

    if on_error not in ("raise", "none"):
        raise ValueError(f"on_error must be 'raise' or 'none', got {on_error!r}")

    def scalar_or_failed(i):
        try:
            return _scalar_fallback(sources[i], output, True)
        except VorbisError:
            if on_error == "raise":
                raise
            return None

    fmt = "s16d" if output == "s16" else "f32"
    outs: list = [None] * len(sources)
    fronts: dict = {}
    groups: dict = {}
    for i, src in enumerate(sources):
        try:
            front = _front_end(src)
        except BatchUnsupported:
            front = None
        except VorbisError:
            if on_error == "raise":
                raise
            continue  # slot stays None
        if front is None:
            outs[i] = scalar_or_failed(i)
            continue
        fronts[i] = front
        # group by channel count only — bucket keys carry setup identity
        # (BucketKey.sid), so heterogeneous setups share one shard_map
        # program family per channel count
        groups.setdefault(front[1], []).append(i)

    n_shards = int(np.prod(list(mesh.shape.values())))
    for channels, idxs in groups.items():
        synth = _synthesizer_for(fronts[idxs[0]][0], channels)
        for i in idxs[1:]:
            synth.add_setup(fronts[i][0])
        costs = [fronts[i][2].n_frames for i in idxs]
        if sum(costs) == 0:
            # no decodable audio frames anywhere in this group (e.g.
            # headers-only streams): no fused program exists over an
            # empty frame set — the scalar anchor is authoritative
            # (same guard as decode_corpus's dispatch)
            for i in idxs:
                outs[i] = scalar_or_failed(i)
            continue
        parts = partition_indices(costs, n_shards)
        shard_items = [
            [fronts[idxs[j]][2:4] for j in part] for part in parts
        ]
        try:
            sig, out, totals, lens, _wb = sharded_chunk_run(
                synth, shard_items, mesh, fmt
            )
            if fmt == "s16d":
                # probe every shard's header first: if ANY shard's packed
                # size overflows a soft wire section, re-run the whole
                # group with the full-capacity pack (identical wire bytes)
                from ..ops.pcm_pack import (
                    PackOverflow,
                    _check_sections,
                    _parse_header,
                    wire_header_bytes,
                    wire_rows,
                )

                nbt_w = wire_rows(sig[3], channels)
                hdr_w = wire_header_bytes(channels)

                def _overflows(k: int) -> bool:
                    h = np.asarray(out[k][: hdr_w + nbt_w])
                    try:
                        _check_sections(
                            *_parse_header(h, nbt_w, channels),
                            int(out.shape[-1]) - hdr_w - nbt_w,
                        )
                    except PackOverflow:
                        return True
                    return False

                over = any(
                    _overflows(k) for k, part in enumerate(parts) if part
                )
                if over:
                    sig, out, totals, lens, _wb = sharded_chunk_run(
                        synth, shard_items, mesh, "s16df"
                    )
            if output == "device":
                # keep PCM in HBM: out[k] is shard k's [C, padded] row on
                # its own device; per-stream results are device slices
                for k, part in enumerate(parts):
                    if not part:
                        continue
                    row = out[k][..., : totals[k]]
                    c = 0
                    for j, ln in zip(part, lens[k]):
                        outs[idxs[j]] = row[:, c : c + ln]
                        c += ln
                continue
            for k, part in enumerate(parts):
                if not part:
                    continue
                pcm = unpack_shard(np.asarray(out[k]), sig, channels, totals[k])
                if pcm.dtype == np.float32:
                    # match decode_corpus's default host f32 contract
                    # (clip_samples=True) and this function's own scalar
                    # fallback — one corpus, one clipping policy (the row
                    # is a read-only device-backed view: clip out of place)
                    pcm = np.clip(pcm, -CLIP_MAX, CLIP_MAX)
                c = 0
                for j, ln in zip(part, lens[k]):
                    outs[idxs[j]] = pcm[:, c : c + ln]
                    c += ln
        except (ShardMismatch, BatchUnsupported):
            # per-device dispatch; a stream the batch planner rejects at
            # prepare time degrades further to the scalar decoder rather
            # than aborting the whole corpus
            for k, part in enumerate(parts):
                for j in part:
                    plan, buckets = fronts[idxs[j]][2:4]
                    dev0 = mesh.devices.flat[0]
                    try:
                        sig2, args2, total2 = synth.prepare(
                            plan, buckets, fmt, device=dev0
                        )
                        res = synth.run(sig2, args2, total2)
                    except BatchUnsupported:
                        outs[idxs[j]] = scalar_or_failed(idxs[j])
                        continue
                    if output == "device":
                        # run() already sliced to [C, total]; keep in HBM
                        outs[idxs[j]] = res
                    elif isinstance(res, tuple):
                        from ..ops.pcm_pack import (
                            PackOverflow,
                            pull_wire,
                            unpack_pcm,
                        )

                        try:
                            _, buf, nbt, out_len, total = res[:5]
                            nb, wtab, cuts, data = pull_wire(
                                buf, nbt, channels
                            )
                        except PackOverflow:
                            # re-run this stream with the full-cap pack
                            sig2, args2, total2 = synth.prepare(
                                plan, buckets, "s16df", device=dev0
                            )
                            res = synth.run(sig2, args2, total2)
                            _, buf, nbt, out_len, total = res[:5]
                            nb, wtab, cuts, data = pull_wire(
                                buf, nbt, channels
                            )
                        outs[idxs[j]] = unpack_pcm(
                            data, wtab, channels, out_len, cuts
                        )[:, :total]
                    else:
                        pcm = np.array(res, dtype=np.float32)
                        np.clip(pcm, -CLIP_MAX, CLIP_MAX, out=pcm)
                        outs[idxs[j]] = pcm
    return outs
