"""Batch decode pipeline: ONE fused XLA program from packed host
tensors to PCM.

The flagship compute path of the framework. The host front end (frames.py)
emits per-bucket tensors packed into four typed transfer buffers;
everything from there to PCM runs on device as a single program:

    residue reconstruction — from bit-packed entropy SYMBOLS
    (ops/residue_sym, the default: codebook entry numbers expand on device
    via table lookups + cumsum ranking + one row gather per cascade pass)
    or from sparse-packed VALUES (block gather fallback) -> floor curves
    (ops/floor, gather-free one-hot contractions) -> coupling inverse
    (ops/coupling) -> spectrum = residue * floor -> IMDCT + window
    (ops/imdct, compensated f32 matmul) -> priming/final masks ->
    overlap-add (ops/ola.block_assemble_wide, phase-decomposed from host
    events at W=128 rows) -> s16 quantize + wire packing (raw /
    byte planes / delta block-pack, ops/pcm_pack)

Replaces the reference's serial packet loop + per-channel IMDCT + lapping
(NVorbis/StreamDecoder.cs:640-791) with frame-parallel device math; the
scalar decoder (decoder.py) is the behavioral anchor it is tested against.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np

from ..decoder import StreamDecoder, CLIP_MAX
from ..dsp.window import full_window
from ..frames import BatchUnsupported, BucketBatch, FramePlan, build_plan, extract_batch
from ..ogg.container import OggContainer
from ..ops.coupling import inverse_couple_batch
from ..ops.floor import floor0_curves, floor1_curves, floor1_unwrap
from ..ops.imdct import imdct_window_batch
from ..ops.ola import OlaUnsupported, block_assemble_wide
from ..ops import pcm_pack
from ..ops.pcm_pack import pack_pcm
from ..ops.residue_sym import expand_submap, pack_bits
from ..setup.mode import window_geometry


def _pad_size(x: int, base: int = 64) -> int:
    """Quantized padding: round up to a 1.5x-geometric size series
    (64, 96, 128, 192, 256, ...). Bounds both wasted compute (<=50%) and the
    number of distinct compiled shapes (~2 per octave) so corpus decode hits
    the jit cache instead of recompiling per stream."""
    if x <= base:
        return base
    s = base
    while s < x:
        s2 = s + s // 2
        if s2 >= x:
            return s2
        s *= 2
    return s


class _LRUPrograms(OrderedDict):
    """Bounded program cache: synthesizers live process-wide (one per
    channel count, models/corpus.py), so an unbounded `_fns` would retain
    every compiled fused program a heterogeneous workload ever produced.
    Evicts least-recently-used; the persistent jit cache keeps the binary,
    so re-admission costs a trace + cache load, not a fresh compile.

    get/__setitem__ take a lock: the process-wide synthesizer is reachable
    from concurrent decode_corpus callers, and OrderedDict reorder/popitem
    under concurrent mutation is not a documented-safe operation even
    under the GIL (contention is negligible next to dispatch cost)."""

    MAX = 64

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            v = super().get(key, default)
            if key in self:
                self.move_to_end(key)
            return v

    def __setitem__(self, key, value):
        with self._lock:
            super().__setitem__(key, value)
            self.move_to_end(key)
            while len(self) > self.MAX:
                self.popitem(last=False)


class BatchSynthesizer:
    """Per-stream-setup device synthesis. Bucket functions are jitted once
    per (bucket key, padded frame count) and cached."""

    def __init__(self, setup, channels: int):
        self.setup = setup
        self.channels = channels
        #: sid -> parsed setup: buckets name their setup via key.sid, so
        #: ONE synthesizer (and one fused program) can carry buckets from
        #: DIFFERENT setups in a merged cross-setup chunk. Bounded LRU
        #: (advisor r3): a long-lived heterogeneous service must not
        #: retain every setup (+ its _sym_layout/codebook arrays) ever
        #: seen. Safe because every decode_corpus call re-registers its
        #: setups up front (_synthesizer_for -> add_setup, and merge
        #: registration at prepare), so a live sid is always fresher than
        #: SETUPS_MAX older ones.
        self.setups: OrderedDict = OrderedDict()
        self._setups_lock = threading.Lock()
        self.add_setup(setup)
        self._fns: dict = _LRUPrograms()

    # -- one bucket: [F, C, half] tensors -> [F, C, n] windowed frames ----------

    #: retention bound for registered setups (LRU evicted beyond this)
    SETUPS_MAX = 128

    def add_setup(self, setup) -> None:
        """Register a setup so its buckets (key.sid) resolve; merged
        cross-setup chunks register every member stream's setup.

        Guarded: the process-wide synthesizer is reached from the corpus
        dispatch thread AND collector threads (the soft-cap overflow
        redispatch re-prepares on a collector worker), and OrderedDict
        reorder/evict under concurrent mutation is not documented-safe."""
        from ..frames import setup_sid

        with self._setups_lock:
            self.setups[setup_sid(setup)] = setup
            self.setups.move_to_end(setup_sid(setup))
            while len(self.setups) > self.SETUPS_MAX:
                self.setups.popitem(last=False)

    def _setup_for(self, key):
        with self._setups_lock:
            s = self.setups.get(key.sid)
            if s is not None:
                self.setups.move_to_end(key.sid)
        if s is None:
            if key.sid == 0:  # hand-built test buckets (no extract stamp)
                return self.setup
            # raced eviction (a chunk with >SETUPS_MAX member setups, or a
            # concurrent corpus evicting this one's sids between add_setup
            # and trace): BatchUnsupported routes the caller to its
            # fallback (scalar decode) instead of aborting the corpus
            raise BatchUnsupported(
                f"setup sid {key.sid} evicted before trace"
            )
        return s

    def _bucket_static(self, key):
        """(n, window, coupling_steps) — static per bucket key."""
        setup = self._setup_for(key)
        mode = setup.modes[key.mode_idx]
        mapping = setup.mappings[mode.mapping_idx]
        info = window_geometry(
            mode.blocksizes, mode.block_flag, key.prev_flag, key.next_flag
        )
        window = full_window(
            info.n, info.left_start, info.left_end, info.right_start, info.right_end
        ).astype(np.float32)
        return mode.n, window, tuple(mapping.coupling_steps)

    def _synth_math(self, key, residues, prime, final, floor_inputs, group_meta):
        """Traced synthesis body: tensors -> windowed+masked frames [F, C, n]."""
        n, window, coupling_steps = self._bucket_static(key)
        half = n // 2
        center = n // 2
        F = residues.shape[0]
        # floor curves per channel group, then reassemble channel order
        parts = []
        chan_order = []
        for meta, inp in zip(group_meta, floor_inputs):
            nc = len(meta["channels"])
            chan_order.extend(meta["channels"])
            if meta["type"] == 1:
                curves = floor1_curves(
                    inp["posts"].reshape(F * nc, -1),
                    inp["step2"].reshape(F * nc, -1),
                    inp["used"].reshape(F * nc),
                    xs=meta["xs"],
                    multiplier=meta["multiplier"],
                    half=half,
                )
            else:
                curves = floor0_curves(
                    inp["coefficients"].reshape(F * nc, -1),
                    inp["amplitude"].reshape(F * nc),
                    inp["used"].reshape(F * nc),
                    order=meta["order"],
                    bark_map=meta["bark_map"],
                    bark_map_size=meta["bark_map_size"],
                    amplitude_bits=meta["amplitude_bits"],
                    amplitude_offset=meta["amplitude_offset"],
                )
            parts.append(curves.reshape(F, nc, half))
        floors = jnp.concatenate(parts, axis=1)
        inv = np.argsort(np.asarray(chan_order))
        floors = floors[:, inv, :]

        res = inverse_couple_batch(residues, coupling_steps)
        spectra = res * floors
        frames = imdct_window_batch(spectra, jnp.asarray(window))

        j = jnp.arange(n, dtype=jnp.int32)[None, :]
        keep = jnp.where(prime[:, None], j >= center, True) & jnp.where(
            final[:, None], j < center, True
        )
        return frames * keep[:, None, :].astype(frames.dtype)


    @staticmethod
    def _resolve_rice() -> bool:
        """Link-aware rice-mode choice for the dpack wire: rice trades
        exec for wire bytes, which only pays below ~90 MB/s of d2h
        (config.s16_rice / s16_rice_threshold_mbps; measured link rate
        from utils/link.py, +inf on CPU backends)."""
        from ..config import VorbisConfig
        from ..utils.link import d2h_rate_estimate

        cfg = VorbisConfig.default
        if cfg.s16_rice == "on":
            return True
        if cfg.s16_rice == "off":
            return False
        return d2h_rate_estimate() < cfg.s16_rice_threshold_mbps * 1e6

    @staticmethod
    def _floor1_ys_ok(floor) -> bool:
        """Static gate for the coded-ys floor1 wire: every value the
        bitstream can put into ys fits u8 (posts 0/1 are y_bits <= 8 wide
        since range <= 256; the rest are subclass-book ENTRY numbers, so
        books with <= 256 entries bound them statically). Config-level,
        so every chunk of every shard makes the same choice."""
        return all(
            b is None or b.entries <= 256
            for books in floor.subclass_books
            for b in books
        )

    @staticmethod
    def _group_meta(bucket: BucketBatch, pads: dict | None = None):
        from ..config import VorbisConfig

        metas = []
        inputs = []
        for gi, g in enumerate(bucket.floor_groups):
            if g.floor.floor_type == 1:
                use_ys = (
                    VorbisConfig.default.floor1_wire == "ys"
                    and g.ys is not None
                    and BatchSynthesizer._floor1_ys_ok(g.floor)
                )
                if use_ys:
                    # quantized nonzero-count capacity (the compacted u8
                    # value stream): part of the static meta so the jit
                    # signature is stable across similar chunks and
                    # shards (pads force it up to the cross-shard max).
                    # Measured on the bench corpus family: ~59% of tail
                    # values are zero, the rest spread to ~116 — a zero
                    # bitmask + u8 nonzeros is ~4.3 bits/val vs the 9.125
                    # of posts u8 + step2 bits (a nibble+escape wire was
                    # sized first and REJECTED: 29% escape rate).
                    n_nz = int(np.count_nonzero(g.ys[:, :, 2:]))
                    nz_cap = _pad_size(max(n_nz, 1), 2048)
                    if pads:
                        nz_cap = max(
                            nz_cap, pads.get(("ysnz", bucket.key, gi), 0)
                        )
                    metas.append(
                        dict_frozen(
                            type=1,
                            channels=tuple(g.channels),
                            xs=tuple(int(x) for x in g.floor.xs),
                            multiplier=g.floor.multiplier,
                            wire="ys",
                            nz_cap=nz_cap,
                        )
                    )
                else:
                    metas.append(
                        dict_frozen(
                            type=1,
                            channels=tuple(g.channels),
                            xs=tuple(int(x) for x in g.floor.xs),
                            multiplier=g.floor.multiplier,
                        )
                    )
                inputs.append(
                    {"posts": g.posts, "step2": g.step2, "used": g.used}
                )
            else:
                metas.append(
                    dict_frozen(
                        type=0,
                        channels=tuple(g.channels),
                        order=g.floor.order,
                        bark_map=tuple(int(v) for v in g.floor._maps[bucket.n]),
                        bark_map_size=g.floor.bark_map_size,
                        amplitude_bits=g.floor.amplitude_bits,
                        amplitude_offset=g.floor.amplitude_offset,
                    )
                )
                inputs.append(
                    {
                        "coefficients": g.coefficients,
                        "amplitude": g.amplitude,
                        "used": g.used,
                    }
                )
        return tuple(metas), inputs

    # -- full stream --------------------------------------------------------------

    @staticmethod
    def _flat_base(plan: FramePlan, buckets, padded_n):
        """Flat-layout start index of each frame's sample 0: [n_frames]."""
        flat_base = np.zeros(plan.n_frames, dtype=np.int64)
        base = 0
        for bucket, pn in zip(buckets, padded_n):
            Fp, n = pn[0], pn[1]
            flat_base[bucket.frame_indices] = base + np.arange(
                len(bucket.frame_indices), dtype=np.int64
            ) * n
            base += Fp * n
        return flat_base

    def _frame_tables(self, plan: FramePlan, buckets, padded_n):
        """Per-frame OLA tables (host, tiny): effective support offsets/ends
        in global coordinates and the frame's base index in the flat layout.

        The per-SAMPLE gather indices are derived from these ON DEVICE
        (searchsorted in the fused program) — transferring three [F] arrays
        instead of four [total_samples] arrays.

        ``padded_n``: per-bucket (Fp, n, ...) after row padding — flat layout
        is the concatenation of each bucket's [C, Fp*n] block."""
        s = plan.soa()
        n_frames = plan.n_frames
        # nonzero support of each windowed frame: [left_start, right_end),
        # narrowed to [center, ...) for priming frames and [..., center) for
        # chain-final frames (their outer halves are masked to zero)
        centers = s.n // 2
        sup_start = np.where(s.prime, centers, s.left_start)
        sup_end = np.where(s.final, centers, s.right_end)
        offsets = s.offset
        offsets_eff = offsets + sup_start
        ends_eff = offsets + sup_end
        flat_base = self._flat_base(plan, buckets, padded_n)
        # validity checks: ascending supports, coverage depth <= 2 (these
        # hold for all spec-conformant window geometry, incl. across chain
        # boundaries — chain-final/priming masks confine each chain's
        # nonzero samples to its own [base, base+span) range)
        if np.any(np.diff(offsets_eff) < 0):
            raise OlaUnsupported("frame supports not ascending")
        if n_frames >= 3 and not np.all(ends_eff[:-2] <= offsets_eff[2:]):
            raise OlaUnsupported("three frames overlap one sample")
        # every kept sample must be covered (the device gather cannot raise;
        # a hole would decode as silent zeros instead of a loud fallback)
        for chain in plan.chains:
            ch = np.asarray(chain, dtype=np.int64)
            if len(ch) >= 2 and not np.all(
                offsets_eff[ch][1:] <= ends_eff[ch][:-1]
            ):
                raise OlaUnsupported("output sample not covered by any frame")
        return (
            offsets_eff.astype(np.int32),
            ends_eff.astype(np.int32),
            (flat_base + sup_start - offsets_eff).astype(np.int32),  # fbase-off
        )

    @staticmethod
    def _build_events(offs, ends, fbase, segs, total):
        """j-domain OLA mapping events (host, tiny).

        Within a RUN (one frame covering consecutive kept outputs) the
        gather indices a_idx/b_idx advance by exactly +1 per sample and
        the validity masks are constant-until-one-flip, so the device can
        reconstruct all four per-sample arrays with unit scatters +
        cumsums — no per-sample table gathers (chosen where a large take
        cost several cumsums; not re-measured on the GPU). Events are segment
        starts, frame crossings (offs hit), validity turn-offs (ends
        hit), and one terminal reset at j=total.

        Returns int32 arrays (ev_j, ev_da, ev_db, ev_va, ev_vb): at each
        ev_j, ev_da/ev_db adjust the +1/sample drift of a_idx/b_idx and
        ev_va/ev_vb add validity-level deltas."""
        F = len(offs)
        j_l, f_l, p_l, e_l = [], [], [], []
        c = 0
        for s_, e_ in segs:
            if e_ <= s_:
                continue
            lk = int(e_ - s_)
            f0 = int(np.searchsorted(offs, s_, side="right")) - 1
            f_hi = int(np.searchsorted(offs, e_ - 1, side="right"))
            cross = np.arange(f0 + 1, f_hi, dtype=np.int64)
            rj = np.concatenate([[c], c + offs[cross] - s_])
            rf = np.concatenate([[f0], cross])
            j_l.append(rj)
            f_l.append(rf)
            p_l.append(s_ + rj - c)
            e_l.append(np.concatenate([rj[1:], [c + lk]]))
            c += lk
        zero = np.zeros(1, dtype=np.int32)
        if not j_l:
            return zero, zero, zero, zero.copy(), zero.copy()
        rj = np.concatenate(j_l).astype(np.int64)
        rf = np.concatenate(f_l).astype(np.int64)
        rp = np.concatenate(p_l).astype(np.int64)
        re_ = np.concatenate(e_l).astype(np.int64)
        offs = offs.astype(np.int64)
        ends = ends.astype(np.int64)
        fbase = fbase.astype(np.int64)
        acl = np.clip(rf, 0, F - 1)
        bcl = np.clip(rf - 1, 0, F - 1)
        a_tgt = fbase[acl] + rp
        b_tgt = fbase[bcl] + rp
        # index deltas vs the natural +1/sample drift between events
        step = rj[1:] - rj[:-1]
        da = a_tgt - np.concatenate([[0], a_tgt[:-1] + step])
        db = b_tgt - np.concatenate([[0], b_tgt[:-1] + step])
        # validity: level at run start, mid-run turn-off when pos hits the
        # frame's effective end, carry into the next (j-contiguous) run
        va_on = (rf >= 0) & (rp < ends[acl])
        vb_on = (rf > 0) & (rp < ends[bcl])
        va_off = rj + np.maximum(ends[acl] - rp, 0)
        vb_off = rj + np.maximum(ends[bcl] - rp, 0)
        va_in = va_on & (va_off < re_)
        vb_in = vb_on & (vb_off < re_)
        va_lvl = (va_on & ~va_in).astype(np.int64)  # level carried out
        vb_lvl = (vb_on & ~vb_in).astype(np.int64)
        dva = va_on.astype(np.int64) - np.concatenate([[0], va_lvl[:-1]])
        dvb = vb_on.astype(np.int64) - np.concatenate([[0], vb_lvl[:-1]])
        nz = np.zeros
        ev_j = np.concatenate(
            [rj, va_off[va_in], vb_off[vb_in], [total]]
        )
        ev_da = np.concatenate(
            [da, nz(va_in.sum()), nz(vb_in.sum()), [0]]
        )
        ev_db = np.concatenate(
            [db, nz(va_in.sum()), nz(vb_in.sum()), [0]]
        )
        ev_va = np.concatenate(
            [dva, -np.ones(va_in.sum()), nz(vb_in.sum()), [-va_lvl[-1]]]
        )
        ev_vb = np.concatenate(
            [dvb, nz(va_in.sum()), -np.ones(vb_in.sum()), [-vb_lvl[-1]]]
        )
        return (
            ev_j.astype(np.int32),
            ev_da.astype(np.int32),
            ev_db.astype(np.int32),
            ev_va.astype(np.int32),
            ev_vb.astype(np.int32),
        )

    def _sym_static(self, key):
        """Structural description of symbol transport for one bucket key
        (cached): per submap the region geometry, the submap's groups in
        wire order and their VQ value tables (zero row appended for the
        end-of-packet sentinel). Submap/pass/group enumeration order
        matches native/symbols.py group_enumeration() and the extract's
        SymBucket arrays. ``None`` entries mark submaps with no channels or
        no coded region (their channels decode as zero residue)."""
        cached = self._fns.get(("symstatic", key))
        if cached is not None:
            return cached
        from ..native.symbols import _vec_shape

        setup = self._setup_for(key)
        mode = setup.modes[key.mode_idx]
        mapping = setup.mappings[mode.mapping_idx]
        layout = setup._sym_layout
        groups_m = layout.groups_per_mapping[mode.mapping_idx]
        half = mode.n // 2
        subs = []
        for sm in range(mapping.submaps):
            r = mapping.submap_residue[sm]
            ch_list = [
                c for c in range(self.channels) if mapping.mux[c] == sm
            ]
            V, vec_len, limit_begin, Pt = _vec_shape(r, half, len(ch_list))
            if not ch_list or Pt == 0:
                subs.append(
                    {"sm": sm, "ch_list": ch_list, "sig": None,
                     "gis": [], "groups": [], "vqs": []}
                )
                continue
            # wire order: groups of this submap across passes (pass-major,
            # matching group_enumeration); the device only needs each
            # group's VQ table — book selection / rank / pair counts are
            # all baked into the host-precomputed scatter indices
            gis = [
                gi
                for gi, g in enumerate(groups_m)
                if g.submap == sm
            ]
            vqs = [
                np.concatenate(
                    [
                        np.asarray(
                            setup.codebooks[groups_m[gi].book_idx].lookup_table,
                            dtype=np.float32,
                        ),
                        np.zeros((1, groups_m[gi].dims), dtype=np.float32),
                    ]
                )
                for gi in gis
            ]
            subs.append(
                {
                    "sm": sm,
                    "ch_list": ch_list,
                    "sig": (
                        V, Pt, r.partition_size, limit_begin, vec_len,
                        r.residue_type == 2,
                    ),
                    "gis": gis,
                    "groups": [groups_m[gi] for gi in gis],
                    "vqs": vqs,
                }
            )
        res = {"subs": subs}
        self._fns[("symstatic", key)] = res
        return res

    #: largest packed-row count still addressable by the 16-bit gather-map
    #: tier (65535 minus the zero row); tests lower it to force the i32 tier
    GMAP_U16_MAX = 65534

    #: sparse-residue packing granularity (columns per block). Residue
    #: spectra are 80-98% zero in practice; nonzero 32-column blocks are
    #: shipped packed (int16 when the values are integral — they are sums of
    #: small lattice codebook entries — else float32) plus a per-block
    #: gather map. Cuts the dominant host->device transfer 4-20x, losslessly.
    PACK_GRAN = 32

    @staticmethod
    def _layout(statics, padded_n, channels):
        """Static packed-transfer layout: every host tensor gets a
        (buffer-tag, offset, shape) slot in one of FOUR flat transfer
        buffers (f32 / i32 / i16 / u8). Packing turns ~25 small host->device
        copies per stream into 4 — transfer count, not bytes, dominates
        latency on thin interconnects.

        ``padded_n`` per bucket: (Fp, n, Kp, ptag, gtag) — padded rows,
        blocksize, padded packed-block count, packed dtype tag, gather-map
        dtype tag ("u16" rides the i16 buffer bit-cast; "i32" when the
        packed-row count exceeds 16 bits)."""
        counts = {"f32": 0, "i32": 0, "i16": 0, "u8": 0}
        PG = BatchSynthesizer.PACK_GRAN

        def slot(tag, shape):
            size = int(np.prod(shape))
            off = counts[tag]
            counts[tag] += size
            return (tag, off, shape)

        entries = []
        for (key, metas), pn in zip(statics, padded_n):
            Fp, n = pn[0], pn[1]
            half = n // 2
            if pn[2] == "sym":
                # symbol transport: bit-packed entry streams per
                # (submap, pass, book) + parallel bit-packed scatter
                # indices, one per applied partition (ops/residue_sym.py)
                sub_sigs = pn[3]
                e = {
                    "syms": [],
                    "idx": [],
                    "groups": [],
                }
                for ss in sub_sigs:
                    if ss is None:
                        e["syms"].append([])
                        e["idx"].append([])
                        continue
                    V, Pt, psize, lb, vl, fmt2, w_i, sgroups = ss
                    gs = []
                    xs = []
                    for (w, d, nsym, fmt1, np_pad) in sgroups:
                        gs.append(
                            slot("u8", ((np_pad * nsym * w + 7) // 8,))
                        )
                        xs.append(
                            slot("u8", ((np_pad * w_i + 7) // 8,))
                        )
                    e["syms"].append(gs)
                    e["idx"].append(xs)
            else:
                Kp, ptag, gtag = pn[2], pn[3], pn[4]
                npart = half // PG
                e = {
                    "gmap": slot(
                        "i16" if gtag == "u16" else "i32",
                        (Fp * channels * npart,),
                    ),
                    # "u8b" = int8 values shipped +128-biased in the u8 buffer
                    "packed": slot("u8" if ptag == "u8b" else ptag, (Kp, PG)),
                    "groups": [],
                }
            for meta in metas:
                nc = len(meta["channels"])
                if meta["type"] == 1:
                    P = len(meta["xs"])
                    if dict(meta).get("wire") == "ys":
                        # coded-values wire: posts 0/1 raw u8 (y_bits wide),
                        # the other P-2 values as a zero bitmask + the
                        # compacted nonzero values u8 (~59% of coded
                        # values are zero); the device rebuilds ys and
                        # runs the spec 7.2.2 unwrap cascade
                        # (ops/floor.floor1_unwrap)
                        P2 = P - 2
                        g = {"ys01": slot("u8", (Fp, nc, 2))}
                        if P2 > 0:
                            g["ysmask"] = slot(
                                "u8", (Fp, nc, (P2 + 7) // 8)
                            )
                            g["ysnz"] = slot("u8", (meta["nz_cap"],))
                    else:
                        g = {
                            "posts": slot("u8", (Fp, nc, P)),
                            # one bit per post, packed little-endian (u8[P]
                            # would be 7/8ths padding on the wire)
                            "step2": slot("u8", (Fp, nc, (P + 7) // 8)),
                        }
                else:
                    g = {
                        "coefficients": slot("f32", (Fp, nc, meta["order"])),
                        "amplitude": slot("i32", (Fp, nc)),
                    }
                g["used"] = slot("u8", (Fp, nc))
                e["groups"].append(g)
            e["prime"] = slot("u8", (Fp,))
            e["final"] = slot("u8", (Fp,))
            entries.append(e)
        return entries, counts

    def _fused_fn(self, sig):
        """One jitted XLA program: every bucket's synthesis + device-side
        OLA index computation + the two-gather assembly."""
        cached = self._fns.get(("fused", sig))
        if cached is not None:
            return cached
        jitted = jax.jit(self._fused_body(sig))
        self._fns[("fused", sig)] = jitted
        return jitted

    def _fused_body(self, sig):
        """The raw (untraced) fused function for ``sig`` — the same body
        _fused_fn jits; parallel/corpus.py wraps it in shard_map so the
        PRODUCTION pipeline (symbol residues, mixed blocksizes, trims,
        dpack) runs SPMD over a stream-sharded mesh."""
        statics = list(sig[0])  # tuple of (key, metas)
        padded_n = list(sig[1])
        output = sig[5]  # "f32" | "s16"
        entries, _ = self._layout(statics, padded_n, self.channels)
        C = self.channels

        def fused(f32_buf, i32_buf, i16_buf, u8_buf, *rest):
            bufs = {"f32": f32_buf, "i32": i32_buf, "i16": i16_buf, "u8": u8_buf}

            def take(slot_, bool_=False):
                tag, off, shape = slot_
                size = int(np.prod(shape))
                v = bufs[tag][off : off + size].reshape(shape)
                return v.astype(bool) if bool_ else v

            flats = []
            for (key, metas), e, pn in zip(statics, entries, padded_n):
                Fp, n = pn[0], pn[1]
                half = n // 2
                floor_inputs = []
                for meta, g in zip(metas, e["groups"]):
                    if meta["type"] == 1:
                        P = len(meta["xs"])
                        if "ys01" in g:
                            # coded-values wire: rebuild ys from the
                            # zero bitmask + compacted nonzero stream,
                            # then run the unwrap cascade on device
                            nc = len(meta["channels"])
                            Fp_ = Fp
                            ys01 = take(g["ys01"]).astype(jnp.int32)
                            if P > 2:
                                P2 = P - 2
                                mb = take(g["ysmask"])
                                mask = (
                                    jnp.repeat(mb, 8, axis=-1)[..., :P2]
                                    >> (
                                        jnp.arange(P2, dtype=jnp.uint8)
                                        % 8
                                    )
                                ) & 1
                                flat = mask.reshape(-1).astype(jnp.int32)
                                # rank of each set bit = index into the
                                # compacted stream (padded frames have
                                # zero mask, so ranks stay aligned)
                                rank = jnp.cumsum(flat) - 1
                                vals = take(g["ysnz"]).astype(jnp.int32)
                                cap = int(meta["nz_cap"])
                                tail = jnp.where(
                                    flat > 0,
                                    jnp.take(
                                        vals,
                                        jnp.clip(rank, 0, cap - 1),
                                    ),
                                    0,
                                ).reshape(Fp_, nc, P2)
                                ysf = jnp.concatenate(
                                    [ys01, tail], axis=-1
                                )
                            else:
                                ysf = ys01
                            posts_d, step2_d = floor1_unwrap(
                                ysf.reshape(Fp_ * nc, P),
                                xs=meta["xs"],
                                multiplier=meta["multiplier"],
                            )
                            floor_inputs.append(
                                {
                                    "posts": posts_d.reshape(
                                        Fp_, nc, P
                                    ),
                                    "step2": step2_d.reshape(
                                        Fp_, nc, P
                                    ),
                                    "used": take(g["used"], bool_=True),
                                }
                            )
                            continue
                        s2b = take(g["step2"])  # packed bits [Fp, nc, B]
                        step2 = (
                            jnp.repeat(s2b, 8, axis=-1)[..., :P]
                            >> (jnp.arange(P, dtype=jnp.uint8) % 8)
                        ) & 1
                        floor_inputs.append(
                            {
                                "posts": take(g["posts"]).astype(jnp.int32),
                                "step2": step2.astype(bool),
                                "used": take(g["used"], bool_=True),
                            }
                        )
                    else:
                        floor_inputs.append(
                            {
                                "coefficients": take(g["coefficients"]),
                                "amplitude": take(g["amplitude"]),
                                "used": take(g["used"], bool_=True),
                            }
                        )
                if pn[2] == "sym":
                    # residue reconstruction from entropy symbols
                    # (ops/residue_sym.py; wire contract native/symbols.py)
                    sub_sigs = pn[3]
                    rt = self._sym_static(key)
                    parts_ch = []
                    ch_order = []
                    for si, ss in enumerate(sub_sigs):
                        sub_rt = rt["subs"][si]
                        ch_list = sub_rt["ch_list"]
                        if not ch_list:
                            continue
                        ch_order.extend(ch_list)
                        if ss is None:
                            parts_ch.append(
                                jnp.zeros(
                                    (Fp, len(ch_list), half), jnp.float32
                                )
                            )
                            continue
                        v = expand_submap(
                            (*ss, len(ch_list)),
                            [take(s) for s in e["syms"][si]],
                            [take(x) for x in e["idx"][si]],
                            sub_rt["vqs"],
                            Fp,
                        )
                        parts_ch.append(v)
                    res_cat = jnp.concatenate(parts_ch, axis=1)
                    inv_ch = np.argsort(np.asarray(ch_order))
                    residues = res_cat[:, inv_ch, :]
                else:
                    Kp, ptag, gtag = pn[2], pn[3], pn[4]
                    # sparse residue expansion: gather packed nonzero blocks
                    packed = take(e["packed"])  # [Kp, PG]; row 0 -> zero
                    gmap = take(e["gmap"])  # [Fp*C*npart]
                    if gtag == "u16":
                        # u16 row indices ride the i16 buffer bit-for-bit
                        gmap = jax.lax.bitcast_convert_type(
                            gmap, jnp.uint16
                        ).astype(jnp.int32)
                    residues = (
                        jnp.take(packed, gmap, axis=0)
                        .reshape(Fp, C, half)
                        .astype(jnp.float32)
                    )
                    if ptag == "u8b":
                        residues = residues - 128.0  # un-bias (row 0 = 128)
                frames = self._synth_math(
                    key,
                    residues,
                    take(e["prime"], bool_=True),
                    take(e["final"], bool_=True),
                    tuple(floor_inputs),
                    metas,
                )
                flats.append(frames.transpose(1, 0, 2).reshape(C, Fp * n))
            flat = jnp.concatenate(flats, axis=1)

            # ("ev", Ep): phase-decomposed OLA from host events
            # (ops/ola.block_assemble_wide; events arrive j-sorted)
            pcm = block_assemble_wide(flat, rest[:5], sig[3])
            if output in ("s16", "s16p", "s16d", "s16df"):
                # libvorbisfile ov_read-compatible quantization: clip, scale
                # by 32768, rint (matches the testing/oracle s16 gate)
                clipped = jnp.clip(pcm, -CLIP_MAX, CLIP_MAX)
                scaled = clipped * 32768.0
                q = jnp.clip(jnp.round(scaled), -32768.0, 32767.0).astype(
                    jnp.int32
                )
                if output in ("s16d", "s16df"):
                    # delta block-pack wire (ops/pcm_pack.py) as ONE
                    # buffer [hdr: nbytes, plane cap, per-channel unary
                    # cuts][widx][planes|unary]: the host's first page
                    # pull carries the header, so no separate round
                    # trips. "s16d" packs into soft-capacity buffers
                    # (typical content; 3x less compaction gather);
                    # nbytes is exact either way, so a host seeing a
                    # section exceed its cap re-runs the chunk as
                    # "s16df" (full capacity, identical wire bytes).
                    NBt = pcm_pack.wire_rows(sig[3], C)
                    cap = NBt * pcm_pack.G_PER
                    ucap = NBt * pcm_pack.UNARY_WORDS_FULL_PER_BLOCK
                    urow = pcm_pack.UNARY_WORDS_FULL_PER_BLOCK
                    if output == "s16d":
                        cap = min(
                            _pad_size(
                                NBt * pcm_pack.SOFT_GROUPS_PER_BLOCK, 4096
                            ),
                            cap,
                        )
                        ucap = min(
                            _pad_size(
                                NBt * pcm_pack.SOFT_UNARY_WORDS_PER_BLOCK,
                                1024,
                            ),
                            ucap,
                        )
                        urow = pcm_pack.UNARY_ROW_WORDS_SOFT
                    rice = sig[6] if len(sig) > 6 else True
                    payload, nbytes, widx, ch_ubit = pack_pcm(
                        q, cap, ucap, urow, rice=rice
                    )
                    hdr = (
                        nbytes >> jnp.asarray([0, 8, 16, 24], jnp.int32)
                    ).astype(jnp.uint8)
                    plane_cap = jnp.asarray(
                        np.array([16 * cap], dtype=np.uint32).view(np.uint8)
                    )
                    cuts = (
                        (
                            ch_ubit[:, None]
                            >> jnp.asarray(
                                [0, 8, 16, 24], jnp.uint32
                            )[None, :]
                        )
                        & 0xFF
                    ).astype(jnp.uint8).reshape(-1)
                    return jnp.concatenate(
                        [hdr, plane_cap, cuts, widx, payload]
                    )
                if output == "s16p":
                    # byte-plane wire format [2, C, L] u8 (lo, hi biased):
                    # the hi plane is slowly varying and compresses well on
                    # links that compress in flight; hosts recombine
                    # losslessly
                    u = (q + 32768).astype(jnp.uint32)
                    pcm = jnp.stack(
                        [
                            (u & 0xFF).astype(jnp.uint8),
                            (u >> 8).astype(jnp.uint8),
                        ]
                    )
                else:
                    pcm = q.astype(jnp.int16)
            return pcm

        return fused

    def prepare(
        self,
        plan: FramePlan,
        buckets: list[BucketBatch],
        output: str = "f32",
        device=None,
    ):
        """Host half of a decode: pack every tensor into 4 flat transfer
        buffers, start the (async) host->device copies, and return
        ``(sig, device_args, total)`` for run().

        Safe to call from worker threads — transfers overlap other streams'
        device execution."""
        sig, host_args, total = self.prepare_host(plan, buckets, output)
        device_args = tuple(jax.device_put(x, device) for x in host_args)
        return sig, device_args, total

    def prepare_host(
        self,
        plan: FramePlan,
        buckets: list[BucketBatch],
        output: str = "f32",
        pads: dict | None = None,
        accounting: dict | None = None,
    ):
        """prepare() minus the device placement: returns (sig, host numpy
        arrays, total). ``pads`` (from sig_pads/merge_pads) forces padded
        dimensions and wire dtypes UP to cross-shard maxima so independent
        shards of one corpus produce the SAME sig — the precondition for
        running them as one shard_map program.

        ``accounting`` (diagnostic, tools/h2d_breakdown.py): when a dict is
        passed, per-component h2d byte counts accumulate into it — slot
        sizes as SHIPPED (padded layout), keyed by wire component. Pure
        host-side bookkeeping; the produced arrays and sig are identical."""
        PG = self.PACK_GRAN
        metas_per = [self._group_meta(b, pads=pads)[0] for b in buckets]
        # Residue wire format per bucket:
        #   symbol transport (b.sym) — bit-packed classifications + VQ entry
        #   streams, expanded on device (2-3x smaller than packed values);
        #   value transport — sparse-pack residues: nonzero PG-column blocks
        #   only (+ zero row 0). Values are sums of small lattice codebook
        #   entries, so they are integral; most buckets fit int8 (shipped
        #   biased in the u8 buffer, "u8b"), the rest int16. The residue
        #   payload dominates host->device bytes and the interconnect budget
        #   is aggregate, so fewer wire bytes translate 1:1 into throughput.
        packs = []
        padded_n = []
        for b in buckets:
            F = len(b.frame_indices)
            Fp = _pad_size(max(F, 1))
            if pads:
                Fp = max(Fp, pads.get(("Fp", b.key), 0))
            if b.sym is not None:
                st = self._sym_static(b.key)
                sub_sigs = []
                syms_packed = []
                idx_packed = []
                g_seq = 0  # ordinal over (submap, pass, group) enumeration
                for si, sub in enumerate(st["subs"]):
                    if sub["sig"] is None:
                        sub_sigs.append(None)
                        continue
                    V, Pt, psize, lb, vl, fmt2 = sub["sig"]
                    PV = Pt * V
                    # scatter-index wire width: values 0..Fp*PV (sentinel
                    # Fp*PV marks padding; the device scatter drops it)
                    w_i = max(int(Fp * PV).bit_length(), 1)
                    frame_row = np.arange(F, dtype=np.int64) * PV
                    groups = []
                    for gi, g in zip(sub["gis"], sub["groups"]):
                        stream = b.sym.syms[gi]
                        if stream.size % g.nsym:
                            raise BatchUnsupported(
                                "symbol stream not partition-aligned"
                            )
                        np_ = stream.size // g.nsym
                        np_pad = _pad_size(max(np_, 1), 16)
                        if pads:
                            np_pad = max(
                                np_pad,
                                pads.get(("np", b.key, g_seq), 0),
                            )
                        g_seq += 1
                        w = max(int(g.entries).bit_length(), 1)
                        padded = np.full(
                            np_pad * g.nsym, g.entries, dtype=np.uint32
                        )
                        padded[: stream.size] = stream
                        syms_packed.append(pack_bits(padded, w))
                        # region row per applied partition: frame*PV + pv
                        gidx = np.full(np_pad, Fp * PV, dtype=np.int64)
                        gidx[:np_] = (
                            np.repeat(frame_row, b.sym.part_counts[:, gi])
                            + b.sym.slots[gi]
                        )
                        idx_packed.append(pack_bits(gidx, w_i))
                        groups.append((w, g.dims, g.nsym, g.fmt1, np_pad))
                    sub_sigs.append(
                        (V, Pt, psize, lb, vl, fmt2, w_i, tuple(groups))
                    )
                packs.append(("sym", syms_packed, idx_packed))
                padded_n.append((Fp, b.n, "sym", tuple(sub_sigs)))
                continue
            _, C, half = b.residues.shape
            npart = half // PG
            r = b.residues.reshape(F * C * npart, PG)
            nz = np.any(r != 0, axis=1)
            rows = r[nz]
            K = rows.shape[0]
            if K == 0:
                ptag = "u8b"
            elif np.any(rows != np.rint(rows)):
                ptag = "f32"
            else:
                amax = np.abs(rows).max()
                ptag = "u8b" if amax <= 127.0 else (
                    "i16" if amax <= 32000.0 else "f32"
                )
            gmap = np.zeros(F * C * npart, dtype=np.int32)
            gmap[nz] = 1 + np.arange(K, dtype=np.int32)
            # the gather map is a large fraction of the transfer (one index
            # per PG-column block); 16-bit indices suffice until a merged
            # chunk carries >64Ki nonzero blocks in one bucket
            gtag = "u16" if K <= self.GMAP_U16_MAX else "i32"
            Kp = _pad_size(K + 1)
            if pads:
                Kp = max(Kp, pads.get(("Kp", b.key), 0))
                order = {"u8b": 0, "i16": 1, "f32": 2}
                pt = pads.get(("ptag", b.key), "u8b")
                if order[pt] > order[ptag]:
                    ptag = pt
                if pads.get(("gtag", b.key)) == "i32":
                    gtag = "i32"
            packs.append(("val", gmap, rows, K, ptag))
            padded_n.append((Fp, b.n, Kp, ptag, gtag))
        statics = tuple(
            (b.key, metas) for b, metas in zip(buckets, metas_per)
        )
        entries, counts = self._layout(statics, padded_n, self.channels)
        if accounting is not None:
            _ITEM = {"f32": 4, "i32": 4, "i16": 2, "u8": 1}

            def _acc(key: str, slot):
                tag, _off, shape = slot
                accounting[key] = accounting.get(key, 0) + int(
                    np.prod(shape)
                ) * _ITEM[tag]

            for e_, pn, metas_ in zip(entries, padded_n, metas_per):
                if pn[2] == "sym":
                    for gs in e_["syms"]:
                        for s in gs:
                            _acc("sym_streams", s)
                    for xs in e_["idx"]:
                        for s in xs:
                            _acc("sym_scatter_idx", s)
                else:
                    _acc("residue_gmap", e_["gmap"])
                    _acc("residue_rows", e_["packed"])
                _acc("window_flags", e_["prime"])
                _acc("window_flags", e_["final"])
                for ge, meta in zip(e_["groups"], metas_):
                    _acc("floor_used", ge["used"])
                    if meta["type"] == 1:
                        if "ys01" in ge:
                            _acc("floor1_ys01", ge["ys01"])
                            if "ysnz" in ge:
                                _acc("floor1_ysmask", ge["ysmask"])
                                _acc("floor1_ysnz", ge["ysnz"])
                        else:
                            _acc("floor1_posts", ge["posts"])
                            _acc("floor1_step2", ge["step2"])
                    else:
                        _acc("floor0_coeffs", ge["coefficients"])
                        _acc("floor0_amp", ge["amplitude"])
        f32 = np.zeros(counts["f32"], dtype=np.float32)
        i32 = np.zeros(counts["i32"], dtype=np.int32)
        i16 = np.zeros(counts["i16"], dtype=np.int16)
        u8 = np.zeros(counts["u8"], dtype=np.uint8)
        bufs = {"f32": f32, "i32": i32, "i16": i16, "u8": u8}

        def put(slot, value):
            tag, off, shape = slot
            size = int(np.prod(shape))
            view = bufs[tag][off : off + size].reshape(shape)
            view[: value.shape[0]] = value

        for bucket, e, metas, pk in zip(buckets, entries, metas_per, packs):
            if pk[0] == "sym":
                _, syms_packed, idx_packed = pk
                flat_slots = [s for gs in e["syms"] for s in gs]
                for sslot, sdata in zip(flat_slots, syms_packed):
                    put(sslot, sdata)
                flat_idx = [s for xs in e["idx"] for s in xs]
                for xslot, xdata in zip(flat_idx, idx_packed):
                    put(xslot, xdata)
            else:
                _, gmap, rows, K, ptag = pk
                tag, off, shape = e["gmap"]
                if tag == "i16":
                    gmap = gmap.astype(np.uint16).view(np.int16)
                bufs[tag][off : off + len(gmap)] = gmap
                tag, off, shape = e["packed"]
                view = bufs[tag][off : off + int(np.prod(shape))].reshape(
                    shape
                )
                if ptag == "u8b":
                    view[0] = 128  # biased zero row
                    view[1 : K + 1] = (rows + 128.0).astype(np.uint8)
                else:
                    view[1 : K + 1] = rows  # row 0 stays all-zero
            put(e["prime"], bucket.prime.astype(np.uint8))
            put(e["final"], bucket.final.astype(np.uint8))
            for g, ge, meta in zip(bucket.floor_groups, e["groups"], metas):
                put(ge["used"], g.used.astype(np.uint8))
                if meta["type"] == 1:
                    if "ys01" in ge:
                        ys = g.ys.astype(np.int32)  # [F, nc, P]
                        put(ge["ys01"], ys[:, :, :2].astype(np.uint8))
                        if "ysnz" in ge:
                            tail = ys[:, :, 2:]
                            mask = tail != 0
                            put(
                                ge["ysmask"],
                                np.packbits(
                                    mask, axis=-1, bitorder="little"
                                ),
                            )
                            # compacted nonzero values, row-major scan
                            # order (matches the device's cumsum-rank
                            # over the Fp-padded mask: padded frames
                            # carry zero mask bits)
                            cap = ge["ysnz"][2][0]
                            nz = tail[mask]
                            if nz.size > cap:
                                raise BatchUnsupported(
                                    "floor1 ys nonzero stream overflow"
                                )
                            nz_w = np.zeros(cap, dtype=np.uint8)
                            nz_w[: nz.size] = nz
                            put(ge["ysnz"], nz_w)
                    else:
                        put(ge["posts"], g.posts.astype(np.uint8))
                        put(
                            ge["step2"],
                            np.packbits(
                                g.step2.astype(bool),
                                axis=-1,
                                bitorder="little",
                            ),
                        )
                else:
                    put(ge["coefficients"], g.coefficients)
                    put(ge["amplitude"], g.amplitude)

        total = plan.pcm_length
        host_args = [f32, i32, i16, u8]
        offs, ends, fbase_off = self._frame_tables(plan, buckets, padded_n)
        out_len = _pad_size(max(total, 1), 65536)
        if pads:
            out_len = max(out_len, pads.get("out_len", 0))
        evs = self._build_events(
            offs, ends, fbase_off, plan.segments, total
        )
        # events sorted by j: block_assemble derives each event's
        # coverage and chain state from the sorted stream. Then pad to
        # a quantized size; padding scatters at j=out_len, which
        # mode="drop" discards.
        order = np.argsort(evs[0], kind="stable")
        evs = [a[order] for a in evs]
        E = len(evs[0])
        Ep = _pad_size(E, 64)
        if pads:
            Ep = max(Ep, pads.get("Ep", 0))
        for i_, a_ in enumerate(evs):
            pad_arr = np.full(
                Ep, out_len if i_ == 0 else 0, dtype=np.int32
            )
            pad_arr[:E] = a_
            host_args.append(pad_arr)
        if accounting is not None:
            accounting["ola_events"] = (
                accounting.get("ola_events", 0) + Ep * len(evs) * 4
            )
            accounting["total_shipped"] = accounting.get(
                "total_shipped", 0
            ) + sum(a.nbytes for a in host_args)
        seg_sig = ("ev", Ep)
        F_tab = 0
        sig = (
            statics,
            tuple(padded_n),
            seg_sig,
            out_len,
            F_tab,
            output,
            # rice-mode flag for the dpack wire (sig[6]): resolved from
            # config + measured link rate; True for non-dpack outputs so
            # their signatures stay link-independent
            self._resolve_rice()
            if output in ("s16d", "s16df")
            else True,
        )
        return sig, host_args, total

    def run(self, sig, device_args, total):
        fn = self._fused_fn(sig)
        out = fn(*device_args)
        if sig[5] in ("s16d", "s16df"):
            # delta block-pack single-buffer wire covering the PADDED
            # output; callers pull via ops.pcm_pack.pull_wire, unpack,
            # then keep [:, :total]
            out_len = sig[3]
            nbt = pcm_pack.wire_rows(out_len, self.channels)
            return ("dpack", out, nbt, out_len, total)
        # output is padded to the quantized out_len in every position mode;
        # the kept samples occupy the first `total` columns in order
        # (last axis also for the [2, C, L] byte-plane format)
        return out[..., :total]

    def assemble(
        self,
        plan: FramePlan,
        buckets: list[BucketBatch],
        output: str = "f32",
        device=None,
    ) -> jax.Array:
        """Synthesize all buckets and gather-assemble the PCM -> [C, pcm],
        as ONE fused XLA program (single dispatch; overlap-add is two gathers
        per output sample — no scatter, no accumulator).

        ``output``: "f32" (float PCM) or "s16" (device-side clip + quantize,
        libvorbisfile-compatible — halves the device->host transfer).

        All dynamic shapes (bucket rows, frame-table length, output length)
        are padded to a quantized size series so repeated decodes of
        similarly-sized streams reuse the compiled program."""
        if not buckets:
            dt = jnp.int16 if output == "s16" else jnp.float32
            return jnp.zeros((self.channels, 0), dtype=dt)
        return self.run(*self.prepare(plan, buckets, output, device=device))


_PTAG_ORDER = {"u8b": 0, "i16": 1, "f32": 2}


def sig_pads(sig) -> dict:
    """Extract the padded dimensions / wire dtypes of one prepare_host sig
    as a pads dict (the hint format prepare_host consumes)."""
    pads: dict = {}
    statics, padded_n, seg_sig, out_len = sig[0], sig[1], sig[2], sig[3]
    for (key, _metas), pn in zip(statics, padded_n):
        pads[("Fp", key)] = pn[0]
        for gi, meta in enumerate(_metas):
            m = dict(meta)
            if m.get("wire") == "ys":
                pads[("ysnz", key, gi)] = m["nz_cap"]
        if pn[2] == "sym":
            g_seq = 0
            for ss in pn[3]:
                if ss is None:
                    continue
                for (_w, _d, _nsym, _fmt1, np_pad) in ss[7]:
                    pads[("np", key, g_seq)] = np_pad
                    g_seq += 1
        else:
            pads[("Kp", key)] = pn[2]
            pads[("ptag", key)] = pn[3]
            if pn[4] == "i32":
                pads[("gtag", key)] = "i32"
    if seg_sig and seg_sig[0] == "ev":
        pads["Ep"] = seg_sig[1]
    pads["out_len"] = out_len
    return pads


def merge_pads(sigs) -> dict:
    """Elementwise maximum of each sig's pads: preparing every shard with
    the merged pads yields identical sigs whenever the shards share a setup
    and bucket-key list (parallel/corpus.py's shard_map precondition)."""
    out: dict = {}
    for sig in sigs:
        for k, v in sig_pads(sig).items():
            if isinstance(v, str):
                cur = out.get(k)
                if cur is None or _PTAG_ORDER.get(v, 9) > _PTAG_ORDER.get(cur, -1):
                    out[k] = v
            else:
                out[k] = max(out.get(k, 0), v)
    return out


class _FrozenMeta(tuple):
    """Hashable static metadata for jit (a tuple of sorted key/value pairs
    exposing dict-style item access)."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for k, v in tuple.__iter__(self):
                if k == key:
                    return v
            raise KeyError(key)
        return tuple.__getitem__(self, key)


def dict_frozen(**kwargs) -> _FrozenMeta:
    return _FrozenMeta(sorted(kwargs.items()))


# -- stream-level drivers -----------------------------------------------------------


def decode_stream_batch(
    provider, *, clip_samples: bool = True, stats=None,
    max_frames: int | None = None,
) -> np.ndarray:
    """Decode one logical stream entirely through the batch pipeline.

    Returns planar float32 PCM [channels, samples]. Raises BatchUnsupported
    for stream shapes the planner does not model (callers fall back to the
    scalar StreamDecoder). Pass a StreamStats as ``stats`` to receive the
    bit accounting (reference IStreamStats parity for the batch path).

    ``max_frames`` bounds memory for very long streams: the plan splits
    into chunks that decode sequentially (frames.split_plan; per-sample
    bit-identical to the unsplit decode)."""
    from ..frames import split_plan

    dec = StreamDecoder(provider)
    dec.initialize()
    setup = dec._setup
    plan = build_plan(provider, setup)
    plans = split_plan(plan, max_frames) if max_frames else [plan]
    synth = BatchSynthesizer(setup, dec.channels)
    parts = []
    for p in plans:
        buckets = extract_batch(p, setup, dec.channels, ident=dec._ident)
        parts.append(np.array(synth.assemble(p, buckets), dtype=np.float32))
    pcm = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
    if clip_samples:
        np.clip(pcm, -CLIP_MAX, CLIP_MAX, out=pcm)
    if stats is not None:
        stats.sample_rate = dec.sample_rate
        stats.header_bits += dec.stats.header_bits
        stats.container_bits += dec.stats.container_bits
        for fr in plan.frames:
            stats.add_packet(
                samples=fr.info.sample_count,
                audio_bits=8 * len(fr.packet.data),
                waste_bits=0,
                container_bits=fr.packet.container_bits,
            )
    return pcm


def decode_file_batch(source, *, clip_samples: bool = True) -> np.ndarray:
    """Open an Ogg file/stream and batch-decode its first Vorbis stream."""
    import io

    if isinstance(source, (str, bytes, bytearray)) and not isinstance(source, str):
        f = io.BytesIO(source)
    elif isinstance(source, str):
        f = open(source, "rb")
    else:
        f = source
    try:
        container = OggContainer(f)
        if not container.try_init():
            raise BatchUnsupported("no logical stream found")
        provider = container.providers[0]
        return decode_stream_batch(provider, clip_samples=clip_samples)
    finally:
        if isinstance(source, (str, bytes, bytearray)):
            f.close()
