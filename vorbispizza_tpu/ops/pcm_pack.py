"""Delta block-pack: a lossless device-side wire codec for s16 PCM output.

Fewer device->host bytes for host-delivered PCM: they pay wherever the
link, not the device, bounds throughput. Audio PCM is smooth: its second difference needs ~5 bits/sample on
typical program material vs 16 shipped raw. This codec:

  1. second- OR third-difference per 128-sample block, whichever packs
     narrower (d3 wins ~23% on smooth music; ties go to d2; the choice
     rides bit 5 of the width byte and reconstruction chains d3 -> d2 ->
     d1 -> q with carried accumulators),
  2. zigzag to unsigned (max |d2| = 131070 -> 18 bits always suffice; d3
     blocks that would need 19 are forced out of width mode),
  3. per block, the cheaper of two codings by exact bit cost:
     width mode — the narrowest width from WIDTHS holding the block's
     max, LSB-first bit-packed (all block byte sizes are u32-word
     multiples, so compaction is one word gather); or
     rice mode (bit 7) — a k-bit low plane (k from the same rung table)
     through the same matmul/compaction, plus per-sample high parts
     q = z >> k in a shared unary section (q zeros + a 1 terminator),
     built as one cumsum + one scatter-add. Per-sample adaptation below
     the block max buys ~15% wire bytes on decoded music (sized in
     tools/wiresweep.py: rice 0.846x of width-mode wire; escape coding
     and finer width rungs were sized at <4% and rejected),
  4. outputs a single contiguous wire [u32 nbytes][u32 plane cap]
     [u32 ch_ubit[C]][width table u8[NBt]][planes|unary] — the host
     pulls only nbytes (+ header) and unpacks vectorized; the channel
     cuts ch_ubit let the host decode channels in parallel without a
     sequential unary pre-scan.

Measured ~3.2x over raw s16 on decoded music (q0.5) with even d2-only
widths — fine widths + d3 added ~1.45x, rice another ~1.18x —
deterministically, whatever compression the link may apply in flight. Wholly new capability vs the reference (NVorbis
returns PCM in host memory by construction); the reference analog of
the output stage is StreamDecoder.StoreInterleaved:515-592.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: allowed block bit-widths; every w gives a u32-word-multiple block size
#: (128*w/8 = 16*w bytes). Fine granularity where blocks actually land
#: (measured on decoded music q0.4-0.5: 95% of blocks at w<=4, ~99% at
#: w<=6, nothing above 12), coarse escape rungs above: a block rounds up
#: to the next available width, costing ~0.7% extra wire bytes, while the
#: device-side all-widths selection matmul shrinks with sum(WIDTHS)
#: (16*84=1344 output columns vs 2736 for full 0..18). 18 always suffices
#: (zigzagged d2 of s16 spans 18 bits). Must match the W[] table in
#: native/frontend.cpp vp_unpack_pcm.
WIDTHS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 18)
BLOCK = 128
MAX_W = WIDTHS[-1]
#: u32 words per block for each width
WORDS = tuple(w * BLOCK // 32 for w in WIDTHS)

#: Rice k rungs = the WIDTHS entries usable as a low-plane width (the
#: k-bit plane rides the same selection matmul, so k must come from the
#: same table; 18 never wins — the +1 terminator bit always loses to
#: plain width-18 coding). Indices into WIDTHS.
RICE_K_IDX = tuple(i for i, w in enumerate(WIDTHS) if w <= 15)

#: unary-section capacities, u32 words per block. Hard bound: a block
#: only picks rice when its total (plane + unary) undercuts its
#: width-mode size <= BLOCK*MAX_W bits = 288 B, so 72 words/block can
#: never truncate. Two soft caps (both re-run full-cap on overflow,
#: detected exactly from the header):
#:   - ROW cap: the per-block deposit row width (a single block's unary
#:     words). Measured music mean is ~8 words/block (256 bits — the
#:     coarse k rungs above 6 shift bits from the plane into unary);
#:     32 words = 4x headroom per block.
#:   - chunk cap: the compaction output, an AVERAGE over the chunk's
#:     blocks (like SOFT_GROUPS_PER_BLOCK). 12 words/block is ~1.5x the
#:     mean; the take count sets the assembly gather's cost.
UNARY_WORDS_FULL_PER_BLOCK = BLOCK * MAX_W // 32
UNARY_ROW_WORDS_SOFT = 32
SOFT_UNARY_WORDS_PER_BLOCK = 12


def wire_header_bytes(channels: int) -> int:
    """dpack wire header size: u32 nbytes, u32 plane-section capacity,
    u32 per-channel cumulative unary bit counts (inclusive ends). The
    channel cuts make the host unpack parallel across channels without a
    sequential pre-scan of the unary stream."""
    return 8 + 4 * channels


def wire_rows(out_len: int, channels: int = 1) -> int:
    """Width-byte rows of the dpack wire header for ``out_len`` samples:
    one byte per BLOCK-sample block per channel ([nbytes][widx][payload]
    layout). The single place wire geometry is derived from BLOCK — the
    unpack/overflow sites must agree with pack_pcm byte for byte."""
    return channels * (-(-out_len // BLOCK))



#: spec channel orders (Vorbis I §4.3.9) put center/LFE between the
#: correlated L/R and surround pairs; pair those, leave center/LFE/rear-
#: center unpaired. 1/2/4ch orders are already adjacent-correlated; >8 is
#: application-defined, adjacent fallback.
_PARTNERS = {
    3: (0, 1, 0),                   # L C R
    5: (0, 1, 0, 3, 3),             # L C R Rl Rr
    6: (0, 1, 0, 3, 3, 5),          # L C R Rl Rr LFE
    7: (0, 1, 0, 3, 3, 5, 6),       # L C R Sl Sr Rc LFE
    8: (0, 1, 0, 3, 3, 5, 5, 7),    # L C R Sl Sr Rl Rr LFE
}


def pair_partner(C: int) -> np.ndarray:
    """Per-channel inter-candidate partner (partner[c] == c means channel
    c has no inter candidates). Adjacent pairing would couple
    uncorrelated channels on the 3/5/6/7/8-channel spec orders (e.g. L
    with center, Rr with LFE), so those counts pair the correlated
    front L/R and surround pairs per _PARTNERS; every other count pairs
    adjacently: (0,1), (2,3), … Must match the partner table in
    native/frontend.cpp vp_unpack_pcm (wire bit 6 = 'subtract THIS
    table's partner'; _unpack_pcm_numpy calls this function)."""
    if C in _PARTNERS:
        return np.array(_PARTNERS[C])
    ch = np.arange(C)
    return np.where(ch % 2 == 1, ch - 1, ch)


def select_candidate(q: jnp.ndarray, rice: bool = True):
    """Stage 1 of pack_pcm: per-block (candidate x coding-mode) choice by
    exact bit cost. Candidates:
      d2      second difference (baseline; always fits 18 bits)
      d3      third difference (~23% fewer bytes on smooth music)
      i2, i3  inter-channel: dk(ch) - dk(pair partner) — stereo content
      is usually correlated, and diff-space decorrelation needs no
      sample-space stitching (the accumulator chain still tracks ch).
    Coding modes per block:
      width   all samples at the narrowest WIDTHS rung holding the max
      rice    k-bit low plane (k from the same rung table, <=15) + a
              unary stream of the high parts q_i = z_i >> k, each sample
              terminated by a 1 bit. Cost = B*(k+1) + sum(q_i); wins
              ~15% wire bytes on music (per-sample adaptation below the
              block max — sized offline in tools/wiresweep.py). Ties go
              to width mode (cheaper host decode, no unary).
    Width mode forces out candidates whose zigzag exceeds WIDTHS[-1]
    bits; rice absorbs any magnitude, and a block only picks rice when
    cheaper than its width coding, so per-block payload never exceeds
    BLOCK*MAX_W bits. Channels pair (0,1),(2,3)…; even channels and a
    trailing odd channel have no inter candidates. Flag bits in the
    width byte: 5 = third difference, 6 = inter, 7 = rice.

    Returns (blk u32 [NBt, BLOCK] low-plane of the winner — the full
    zigzag for width blocks, z & ((1<<k)-1) for rice blocks; widx i32
    [NBt] rung index; blk_flags i32 [NBt]; ulen i32 [NBt, BLOCK]
    per-sample unary lengths (q_i + 1 on rice blocks, 0 elsewhere) for
    pack_unary). Module-level so tools/ablate.py can snap the candidate
    search out (d2-only) and attribute its exec cost.

    ``rice=False`` disables the rice candidate entirely (width-only
    coding, ulen all-zero): the rice mode trades exec for wire bytes,
    which only pays on thin links — config.s16_rice/"auto" picks per the
    measured link rate (utils/link.py)."""
    C, L = q.shape
    NB = -(-L // BLOCK)
    pad = NB * BLOCK - L
    d1 = jnp.diff(q, axis=1, prepend=jnp.zeros((C, 1), q.dtype))
    d2 = jnp.diff(d1, axis=1, prepend=jnp.zeros((C, 1), d1.dtype))
    d3 = jnp.diff(d2, axis=1, prepend=jnp.zeros((C, 1), d2.dtype))

    def zig_blocks(d):
        z = ((d << 1) ^ (d >> 31)).astype(jnp.uint32)
        if pad:
            z = jnp.pad(z, ((0, 0), (0, pad)))
        return z.reshape(C * NB, BLOCK)

    def width_index(maxz):
        wi = jnp.zeros(maxz.shape[0], dtype=jnp.int32)
        for w in WIDTHS[:-1]:
            wi = wi + (maxz > ((1 << w) - 1)).astype(jnp.int32)
        return wi

    NBt = C * NB
    cands = [zig_blocks(d2), zig_blocks(d3)]
    flags = [0, 1 << 5]
    if C >= 2:
        partner = pair_partner(C)
        cands.append(zig_blocks(d2 - d2[partner]))
        cands.append(zig_blocks(d3 - d3[partner]))
        flags += [1 << 6, (1 << 5) | (1 << 6)]
        # inter only valid for paired dependents (block t -> ch t//NB)
        inter_ok = jnp.asarray(
            partner[np.arange(NBt) // NB] != (np.arange(NBt) // NB)
        )
    INF = jnp.int32(1 << 29)  # > any real block cost (<= 2^27 bits)
    w_tbl = jnp.asarray(np.asarray(WIDTHS, dtype=np.int32))
    rice_w = np.asarray([WIDTHS[i] for i in RICE_K_IDX], dtype=np.int32)
    rice_idx_tbl = jnp.asarray(np.asarray(RICE_K_IDX, dtype=np.int32))
    costs, widx_c, ridx_c, rice_c = [], [], [], []
    for k, cb in enumerate(cands):
        m = cb.max(axis=1)
        wi = width_index(m)
        wcost = jnp.take(w_tbl, wi) * BLOCK
        wcost = jnp.where(m > ((1 << MAX_W) - 1), INF, wcost)
        if rice:
            # rice: per rung k, B*k + the word-aligned unary segment
            # (sum(z>>k) + B terminators, rounded up to 32); argmin picks
            # the smallest k on ties (rungs are ascending)
            rstack = jnp.stack(
                [
                    BLOCK * int(kw)
                    + (
                        (
                            (cb >> int(kw)).sum(axis=1).astype(jnp.int32)
                            + BLOCK
                            + 31
                        )
                        & ~31
                    )
                    for kw in rice_w
                ]
            )
            rbest = jnp.argmin(rstack, axis=0)
            rcost = jnp.take_along_axis(rstack, rbest[None, :], axis=0)[0]
            use_rice = rcost < wcost  # ties -> width (no unary to decode)
            cost = jnp.minimum(rcost, wcost)
        else:
            rbest = jnp.zeros_like(wi)
            use_rice = jnp.zeros(wi.shape, dtype=bool)
            cost = wcost
        if flags[k] & (1 << 6):
            cost = jnp.where(inter_ok, cost, INF)
        costs.append(cost)
        widx_c.append(jnp.where(use_rice, jnp.take(rice_idx_tbl, rbest), wi))
        ridx_c.append(rbest)
        rice_c.append(use_rice)
    cstack = jnp.stack(costs)  # [K, NBt]
    best = jnp.argmin(cstack, axis=0)  # first min: earlier candidate wins
    # select via where-accumulation, NOT stack + take_along_axis: XLA
    # fuses each masked candidate into the accumulation instead of
    # materializing a [K, NBt, BLOCK] stack in HBM and gathering rows
    blk = cands[0]
    widx = widx_c[0]
    is_rice = rice_c[0]
    for k in range(1, len(cands)):
        sel = best == k
        blk = jnp.where(sel[:, None], cands[k], blk)
        widx = jnp.where(sel, widx_c[k], widx)
        is_rice = jnp.where(sel, rice_c[k], is_rice)
    flag_tbl = jnp.asarray(np.asarray(flags, dtype=np.int32))
    blk_flags = jnp.take(flag_tbl, best) | (
        is_rice.astype(jnp.int32) << 7
    )
    # split the winner at its rung: low plane through the width matmul,
    # high parts (+1 terminator each) into the unary stream
    wv = jnp.take(w_tbl, widx).astype(jnp.uint32)
    mask = jnp.where(
        wv >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << wv) - 1
    )
    high = blk >> wv[:, None]
    ulen = jnp.where(
        is_rice[:, None], (high + 1).astype(jnp.int32), jnp.int32(0)
    )
    blk = jnp.where(is_rice[:, None], blk & mask[:, None], blk)
    return blk, widx, blk_flags, ulen


_sel16_cache: list = []


def _selection_matrix16():
    """Bit-PAIR -> per-width-HALFWORD selection matrix (bf16), columns
    ordered [all EVEN halfwords | all ODD halfwords], plus the 0/1 mask
    for the odd->even carry (0 at each width region's last odd column).

    Vs the byte/bit-plane formulation this is 4x fewer MACs: the operand
    packs two bit planes per element (b_2p + 2*b_2p+1, values 0..3 —
    exact in bf16) and each output column is a 16-bit halfword, both
    halving their axis. A pair whose two bits straddle a halfword
    boundary (q mod 16 == 15) keeps weight 2^q: its odd bit contributes
    2^(q+1) = an overflow into bit 16, which IS that bit's value in the
    next halfword — recovered exactly by the integer carry pass in
    words_matmul. Weights are powers of two (bf16-exact) and column sums
    stay < 2^18 (f32-exact).

    The even/odd column split lets the i32 WORD stream form from two
    contiguous slices (even | odd<<16) with no byte interleave of the
    full matmul output. ``offs`` are per-width offsets in WORD columns
    (half the halfword count)."""
    if not _sel16_cache:
        offs = np.cumsum([0] + [4 * w for w in WIDTHS[1:]])  # word cols
        HALF = int(offs[-1])  # even (= odd) halfword column count
        NPAIR = MAX_W // 2
        M = np.zeros((BLOCK * NPAIR, 2 * HALF), dtype=np.float32)
        carry_oe_ok = np.ones(HALF, dtype=np.float32)
        for wi, w in enumerate(WIDTHS[1:]):
            base = int(offs[wi])  # word base of this width region
            if base > 0:
                # a block's non-chosen width columns hold garbage sums
                # whose >>16 may be nonzero: a carry out of region wi-1's
                # LAST odd halfword must never pollute region wi's first
                # even column. In-region carries are the recovered
                # straddle bits and stay enabled. (The even->odd carry
                # never crosses a region: both halves of a word share
                # one region.)
                carry_oe_ok[base - 1] = 0.0
            for s in range(BLOCK):
                for p in range((w + 1) // 2):
                    q = s * w + 2 * p
                    j = q // 16  # halfword index within the region
                    col = (
                        base + j // 2 if j % 2 == 0 else HALF + base + j // 2
                    )
                    M[p * BLOCK + s, col] += float(1 << (q % 16))
        _sel16_cache.append((M.astype(jnp.bfloat16), offs, carry_oe_ok))
    return _sel16_cache[0]


def words_matmul(blk: jnp.ndarray):
    """Stage 2 of pack_pcm: every width's packed stream as i32 WORDS from
    ONE matmul (bf16 operands, f32 accumulation: exact, see
    _selection_matrix16).

    Bit-pair operand x [NBt, 9*BLOCK] (two planes per element) times the
    static even|odd halfword selection matrix -> integer halfwords + a
    carry pass (straddling pairs overflow bit 16 = bit 0 of the next
    halfword; the receiving halfword misses that bit so +carry cannot
    overflow) -> little-endian u32 words combined from two CONTIGUOUS
    slices. Everything stays 32-bit until after compaction — the
    full-size stream is never materialized as u8. This formulation was
    chosen on the earlier accelerator (an 18-candidate loop, then a
    bit-plane/byte matmul, came before it) and is not re-measured on the
    GPU.

    blk u32 [NBt, BLOCK] -> words i32 [NBt, sum(4*w)]. Module-level for
    tools/ablate.py stage attribution."""
    NBt = blk.shape[0]
    M16, offs, carry_oe_ok = _selection_matrix16()
    HALF = int(offs[-1])
    NPAIR = MAX_W // 2
    # pair-major expansion [NBt, NPAIR, BLOCK]: sample axis stays minor,
    # so the reshape to the matmul operand is layout-free
    pairs = (
        (
            blk[:, None, :]
            >> (2 * jnp.arange(NPAIR, dtype=jnp.uint32))[None, :, None]
        )
        & 3
    ).astype(jnp.bfloat16).reshape(NBt, NPAIR * BLOCK)
    # halfword sums reach ~2^17: bf16 output would round them (bytes
    # <= 255 fit bf16; halfwords do not) — force the f32 accumulator out
    r = jnp.matmul(
        pairs, jnp.asarray(M16), preferred_element_type=jnp.float32
    ).astype(jnp.int32)
    r_even, r_odd = r[:, :HALF], r[:, HALF:]
    h_even = r_even & 0xFFFF
    h_odd = (r_odd & 0xFFFF) + (r_even >> 16)  # even->odd: same word
    # odd->even carry crosses words; masked at width-region boundaries
    c_oe = (r_odd >> 16) * jnp.asarray(carry_oe_ok, jnp.int32)[None, :]
    h_even = h_even + jnp.concatenate(
        [jnp.zeros((NBt, 1), jnp.int32), c_oe[:, :-1]], axis=1
    )
    return h_even | (h_odd << 16)


#: worst-case 16-byte groups per block (width 18)
G_PER = 4 * WORDS[-1] // 16

#: soft compaction capacity, in groups per block AVERAGED over the chunk.
#: A block's group count equals its width index's w (16w bytes); measured
#: music sits at ~2.5 groups/block mean, so 6 is ~2.4x headroom while the
#: compaction gather (whose size follows the cap) shrinks 3x against the
#: full 18-group cap.
#: Content that overflows (near-white-noise PCM) is detected EXACTLY on
#: the host — nbytes in the wire header exceeds the payload capacity ->
#: PackOverflow -> the caller re-runs the chunk with the full-cap
#: program ("s16df"). Wire bytes are identical either way.
SOFT_GROUPS_PER_BLOCK = 6


class PackOverflow(Exception):
    """The chunk's true packed size exceeds the soft-capacity wire buffer;
    re-run with the full-capacity pack program (output="s16df")."""


def compact(words: jnp.ndarray, widx: jnp.ndarray, cap_groups: int | None = None):
    """Stage 3 of pack_pcm: compaction at 16-BYTE (4-word) granularity
    DIRECTLY from the per-width word streams: every width's words sit at
    a static column offset in ``words`` (4w words at 4*cum(w)), so one
    flat row take per output group indexes straight into the matmul
    result — no intermediate select/pad pass materializing masked copies
    of every block. The per-group source row is ``g + comb[blk_of[g]]``
    with comb = blk*COLS + gbase - goff folded into ONE per-block table,
    so the expansion costs one cumsum, one scalar take and one 4-lane
    i32 row take per group; bytes are extracted arithmetically AFTER the
    gather, on the compacted output only.
    ``cap_groups`` bounds the STATIC output (soft cap: see
    SOFT_GROUPS_PER_BLOCK); groups past it are dropped (the true total is
    still returned, so the host detects overflow exactly). Module-level
    for tools/ablate.py stage attribution."""
    NBt = words.shape[0]
    _, offs, _ = _selection_matrix16()
    COLS = int(offs[-1]) // 4  # 4-word group columns per block
    w4flat = words.reshape(NBt * COLS, 4)
    gbase_np = np.zeros(len(WIDTHS), dtype=np.int32)
    gbase_np[1:] = np.asarray(offs[:-1], dtype=np.int32) // 4
    groups_tbl = jnp.asarray(
        np.asarray([4 * wd // 16 for wd in WORDS], dtype=np.int32)
    )
    gpb = jnp.take(groups_tbl, widx)  # groups per block
    goff = jnp.cumsum(gpb) - gpb  # exclusive group offsets
    total_groups = goff[-1] + gpb[-1] if NBt else jnp.int32(0)

    if cap_groups is None:
        cap_groups = NBt * G_PER
    # block id per output group: unit marker at each block's start offset
    # (empty blocks collapse — their marker stacks on the next offset;
    # offsets past the cap drop)
    marker = jnp.zeros(cap_groups + 1, dtype=jnp.int32)
    marker = marker.at[goff].add(1, mode="drop")
    blk_of = jnp.clip(jnp.cumsum(marker[:-1]) - 1, 0, NBt - 1)
    comb = (
        jnp.arange(NBt, dtype=jnp.int32) * COLS
        + jnp.take(jnp.asarray(gbase_np), widx)
        - goff
    )
    idx = jnp.arange(cap_groups, dtype=jnp.int32) + jnp.take(comb, blk_of)
    g4 = jnp.take(w4flat, idx, axis=0, mode="fill", fill_value=0)
    # little-endian byte extraction on the COMPACTED stream only
    packed = (
        (
            g4[:, :, None]
            >> jnp.asarray([0, 8, 16, 24], jnp.int32)[None, None, :]
        )
        & 0xFF
    ).astype(jnp.uint8).reshape(-1)
    return packed, (total_groups * 16).astype(jnp.int32)


def pack_unary(
    ulen: jnp.ndarray,
    channels: int,
    cap_words: int,
    cap_row_words: int = UNARY_WORDS_FULL_PER_BLOCK,
):
    """Stage 4 of pack_pcm: the unary stream as little-endian u32 words.
    ``ulen`` [NBt, BLOCK] carries each sample's unary length (q_i + 1 on
    rice blocks, 0 elsewhere); each rice block's segment is q_i zeros
    then a 1 terminator per sample, PADDED to a u32-word boundary (the
    host cursor rounds up after each rice block's 128th terminator).

    Built block-locally instead of as a global bit-level scatter of one
    update per sample: a per-block deposit (a python loop of masked
    reductions, one per row word — positions are block-local) plus the
    word-granularity marker/cumsum/take compaction (the same pattern as
    compact()). The choice was made on the earlier accelerator, where
    scatter cost grew with the update count, and is not re-measured on
    the GPU. The alignment padding costs ~2 B
    per rice block (~0.9% of the wire) and buys the block-local
    construction AND parallel host unpack.

    Truncation is exact-detectable: a block's bits past ``cap_row_words``
    drop in the deposit (flagged in row_over), words past ``cap_words``
    drop in the take; the true totals still return.

    Returns (ubytes u8 [4*cap_words], ubytes_true i32,
    ch_ubit u32 [channels] cumulative aligned bit counts at channel
    ends, row_over bool — any block exceeded the row cap)."""
    NBt = ulen.shape[0]
    if NBt == 0:
        return (
            jnp.zeros(4 * cap_words, jnp.uint8),
            jnp.int32(0),
            jnp.zeros(channels, jnp.uint32),
            jnp.bool_(False),
        )
    W = cap_row_words
    ends = jnp.cumsum(ulen, axis=1, dtype=jnp.int32)  # block-local
    ubits_b = ends[:, -1]
    uw_b = (ubits_b + 31) >> 5  # words per block (0 for width blocks)
    row_over = jnp.any(uw_b > W)
    # per-block deposit: terminator of sample i at local bit ends[b,i]-1
    pos = ends - 1
    valid = ulen > 0
    wsel = jnp.where(valid, pos >> 5, jnp.int32(W))
    val = jnp.where(
        valid, jnp.uint32(1) << (pos & 31).astype(jnp.uint32), jnp.uint32(0)
    )
    cols = [
        jnp.where(wsel == w, val, jnp.uint32(0)).sum(
            axis=1, dtype=jnp.uint32
        )
        for w in range(W)
    ]
    rows = jnp.stack(cols, axis=1)  # [NBt, W]
    # word-granularity compaction (same marker/cumsum/take as compact())
    goff = jnp.cumsum(uw_b) - uw_b
    total_words = goff[-1] + uw_b[-1]
    NB = NBt // max(channels, 1)
    cut_rows = np.arange(1, channels + 1) * NB - 1
    ch_ubit = (32 * (jnp.take(goff, cut_rows) + jnp.take(uw_b, cut_rows))).astype(
        jnp.uint32
    )
    marker = jnp.zeros(cap_words + 1, dtype=jnp.int32)
    marker = marker.at[goff].add(1, mode="drop")
    blk_of = jnp.clip(jnp.cumsum(marker[:-1]) - 1, 0, NBt - 1)
    comb = jnp.arange(NBt, dtype=jnp.int32) * W - goff
    idx = jnp.arange(cap_words, dtype=jnp.int32) + jnp.take(comb, blk_of)
    words = jnp.take(rows.reshape(-1), idx, mode="fill", fill_value=0)
    ubytes = (
        (
            words[:, None]
            >> jnp.asarray([0, 8, 16, 24], jnp.uint32)[None, :]
        )
        & 0xFF
    ).astype(jnp.uint8).reshape(-1)
    return ubytes, (4 * total_words).astype(jnp.int32), ch_ubit, row_over


def pack_pcm(
    q: jnp.ndarray,
    cap_groups: int | None = None,
    cap_uwords: int | None = None,
    cap_urow: int = UNARY_WORDS_FULL_PER_BLOCK,
    rice: bool = True,
):
    """Device-side pack: q int32 [C, L] (s16-range) ->
    (payload u8 [16*cap_groups + 4*cap_uwords], nbytes int32,
    widx u8 [C*NB], ch_ubit u32 [C]).

    The payload is the plane section (16-byte groups, blocks back-to-back
    in (channel, block) order) with the unary section placed directly
    after the true plane bytes (one dynamic_update_slice), so the wire
    stays a single contiguous region of ``nbytes``. nbytes may exceed
    either section's soft capacity — the host then re-runs with the full
    caps (PackOverflow); a block exceeding the per-block unary row cap
    forces nbytes to a sentinel past any buffer for the same protocol.
    The four stages — candidate selection, word matmul, group
    compaction, unary deposit+compaction — live as module-level
    functions so the on-chip ablation can attribute them."""
    C = q.shape[0]
    blk, widx, blk_flags, ulen = select_candidate(q, rice=rice)
    words = words_matmul(blk)
    NBt = blk.shape[0]
    if cap_groups is None:
        cap_groups = NBt * G_PER
    if cap_uwords is None:
        cap_uwords = NBt * UNARY_WORDS_FULL_PER_BLOCK
    packed, nb_plane = compact(words, widx, cap_groups)
    if not rice:
        # width-only wire: no unary section at all (a valid rice wire
        # with zero rice blocks — the host unpack needs no flag)
        return (
            packed,
            nb_plane,
            (widx | blk_flags).astype(jnp.uint8),
            jnp.zeros(C, jnp.uint32),
        )
    ubytes, ub_true, ch_ubit, row_over = pack_unary(
        ulen, C, cap_uwords, cap_urow
    )
    payload = jnp.concatenate([packed, jnp.zeros_like(ubytes)])
    payload = jax.lax.dynamic_update_slice(
        payload,
        ubytes,
        (jnp.minimum(nb_plane, jnp.int32(16 * cap_groups)),),
    )
    nbytes = nb_plane + ub_true
    # a block past the unary row cap lost bits in the deposit; nbytes
    # alone cannot reveal it, so force the overflow protocol
    nbytes = jnp.where(row_over, jnp.int32(0x7FFFFFF0), nbytes)
    # widx byte: bits 0-4 width/k rung index, bit 5 = third difference,
    # 6 = inter, 7 = rice
    wout = (widx | blk_flags).astype(jnp.uint8)
    return payload, nbytes, wout, ch_ubit


#: page sizes for sized pulls: big pages while >= _PAGE_BIG of payload
#: remains, then one exact _PAGE_QUANTUM-quantized tail (dynamic START,
#: static SIZE — a python-sliced pull would compile one program per
#: distinct length; the quantized sizes bound the set at
#: _PAGE_BIG/_PAGE_QUANTUM programs per buffer shape, each compiled once
#: and cached persistently)
_PAGE_BIG = 4 << 20
#: slice-size quantum shared by start_page0 and pull_wire's tail: both
#: must agree or the compiled-size set doubles. 64 KB: the quantized
#: waste (avg quantum/2 per sized page, two sized pages per chunk) is
#: pure link cost — at 256 KB it came to ~1.4 MB per 480 s corpus (d2h
#: 16.8 vs 15.4 MB payload); the price is a larger slice-program set
#: (bounded at _PAGE_BIG/quantum per buffer shape, and only the handful
#: of sizes a corpus family actually hits compile)
_PAGE_QUANTUM = 64 << 10

_page_fns: dict = {}


def _page_fn(size: int):
    fn = _page_fns.get(size)
    if fn is None:
        import jax

        fn = jax.jit(
            lambda x, i: jax.lax.dynamic_slice_in_dim(x, i, size),
            static_argnames=(),
        )
        _page_fns[size] = fn
    return fn


def start_page0(dev: "jnp.ndarray", hint_bytes: int | None = None):
    """Launch the wire's first page (slice program + async host copy) so
    it rides behind later work; hand the result to pull_wire.

    ``hint_bytes``: host-side estimate of the total wire size (header +
    widx + packed). The wire buffer is the PADDED soft capacity —
    typically ~2x the real payload — so pulling a fixed-size first page
    moves ~1.3 MB of dead padding per chunk over the link (+33% of the
    d2h bytes of the 32-file bench corpus). The first page is sized to
    the _PAGE_QUANTUM-quantized hint instead; an undershoot
    costs one extra sized-page round trip in pull_wire (which already
    pulls any remainder), an overshoot is bounded by the quantum."""
    cap = int(dev.shape[0])
    if hint_bytes is None:
        size = _PAGE_BIG
    else:
        q = _PAGE_QUANTUM
        size = min(_PAGE_BIG, -(-max(int(hint_bytes), 1) // q) * q)
    page = dev if cap <= size else _page_fn(size)(dev, 0)
    try:
        page.copy_to_host_async()
    except (AttributeError, RuntimeError):
        pass
    return page


def plane_bytes_of(widx: np.ndarray) -> int:
    """Exact plane-section byte size from the width table (each block
    contributes 16*W[rung] bytes). Raises on out-of-range rungs — the
    walk must not index garbage on a corrupt wire."""
    wclass = (np.asarray(widx) & 0x1F).astype(np.int64)
    if wclass.size and int(wclass.max()) >= len(WIDTHS):
        raise ValueError(
            f"dpack width class {int(wclass.max())} out of range"
        )
    return int(np.asarray(WIDTHS, dtype=np.int64)[wclass].sum()) * 16


def _parse_header(h: np.ndarray, nbt: int, channels: int):
    """Parse the wire header [u32 nbytes][u32 plane_cap][u32 ch_ubit[C]]
    [widx u8[nbt]] -> (nbytes, plane_cap, ch_ubit, widx)."""
    HDR = wire_header_bytes(channels)
    if h.shape[0] < HDR + nbt:
        # the header + width table must ride the first page; a chunk-size
        # change that overflows it must fail loudly, not corrupt the PCM
        raise ValueError(
            f"dpack header ({HDR + nbt} B) exceeds the first wire page "
            f"({h.shape[0]} B); raise _PAGE_BIG or shrink the chunk"
        )
    nb = int(h[:4].view(np.int32)[0])
    plane_cap = int(h[4:8].view(np.uint32)[0])
    ch_ubit = h[8:HDR].view(np.uint32).copy()
    if ch_ubit.size and np.diff(ch_ubit.astype(np.int64)).min(initial=0) < 0:
        raise ValueError("dpack channel unary cuts are not monotonic")
    widx = h[HDR : HDR + nbt]
    return nb, plane_cap, ch_ubit, widx


def _check_sections(
    nb: int, plane_cap: int, ch_ubit: np.ndarray, widx: np.ndarray,
    payload_cap: int,
):
    """Exact per-section overflow/integrity checks: nbytes in the header
    is always the TRUE total (device drops bytes past either section's
    cap but reports true sizes), so a truncated soft-cap wire is
    detected from the header alone -> PackOverflow (caller re-runs the
    full-cap program). A size mismatch that is not an overflow is a
    corrupt wire -> ValueError. Returns (plane_true, ubytes)."""
    plane_true = plane_bytes_of(widx)
    ubits = int(ch_ubit[-1]) if ch_ubit.size else 0
    ubytes = 4 * ((ubits + 31) // 32)
    if plane_true > plane_cap:
        raise PackOverflow(
            f"dpack plane section {plane_true} B exceeds cap {plane_cap} B"
        )
    if ubytes > payload_cap - plane_cap:
        raise PackOverflow(
            f"dpack unary section {ubytes} B exceeds cap "
            f"{payload_cap - plane_cap} B"
        )
    if nb != plane_true + ubytes:
        raise ValueError(
            f"dpack size mismatch: header {nb} B != plane {plane_true} B "
            f"+ unary {ubytes} B"
        )
    return plane_true, ubytes


def pull_wire(
    dev: "jnp.ndarray",
    nbt: int,
    channels: int = 1,
    page0=None,
    moved_out: list | None = None,
):
    """Pull a single-buffer dpack wire [hdr][widx u8[nbt]][planes|unary]
    -> (nbytes, widx, ch_ubit, payload bytes). The header rides in the
    first page, so a chunk costs no separate round-trips.

    ``moved_out``: optional single-element list accumulating the ACTUAL
    device bytes materialized (page sizes, padding included) — the
    honest d2h counter when the first page is hint-sized past the true
    payload."""
    cap = int(dev.shape[0])
    HDR = wire_header_bytes(channels)
    if page0 is None:
        page0 = start_page0(dev)
    h = np.asarray(page0)
    first = h.shape[0]
    if moved_out is not None:
        moved_out[0] += int(first)
    nb, plane_cap, ch_ubit, widx = _parse_header(h, nbt, channels)
    _check_sections(nb, plane_cap, ch_ubit, widx, cap - HDR - nbt)
    data = np.empty(nb, dtype=np.uint8)
    take0 = min(nb, first - HDR - nbt)
    if take0 > 0:
        data[:take0] = h[HDR + nbt : HDR + nbt + take0]
    off = HDR + nbt  # device offset of the payload
    a = max(take0, 0)
    pages = []
    q = _PAGE_QUANTUM
    while a < nb:
        # big pages while >= _PAGE_BIG remains, then ONE exact
        # _PAGE_QUANTUM-quantized tail page: nb is known here (the header
        # rode the first page), so the remainder ships < _PAGE_QUANTUM of
        # padding, and each distinct quantized size compiles its slice
        # program once
        if nb - a >= _PAGE_BIG and cap >= _PAGE_BIG:
            size = _PAGE_BIG
        else:
            # min() with cap: the quantized tail must still fit a wire
            # buffer smaller than one quantum
            size = min(cap, -(-(nb - a) // q) * q)
        start = min(off + a, cap - size)
        page = _page_fn(size)(dev, start)
        try:
            page.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        take = min(nb - a, size - (off + a - start))
        pages.append((a, start, take, page))
        a += take
    for a, start, take, page in pages:
        hst = np.asarray(page)
        if moved_out is not None:
            moved_out[0] += int(hst.shape[0])
        s0 = off + a - start
        data[a : a + take] = hst[s0 : s0 + take]
    return nb, widx, ch_ubit, data


def unpack_pcm(
    packed: np.ndarray,
    widx: np.ndarray,
    C: int,
    L: int,
    ch_ubit: np.ndarray | None = None,
):
    """Host-side unpack -> int16 [C, L]: the threaded C++ unpacker when
    available (native/frontend.cpp vp_unpack_pcm), else vectorized numpy.
    ``packed`` is the contiguous payload (planes then unary); ``ch_ubit``
    carries the per-channel unary bit cuts (None only for wires with no
    rice blocks)."""
    from .. import native

    if native.available():
        out = native.unpack_pcm(packed, widx, C, L, ch_ubit)
        if out is not None:
            return out
    return _unpack_pcm_numpy(packed, widx, C, L, ch_ubit)


def _unpack_pcm_numpy(
    packed: np.ndarray,
    widx: np.ndarray,
    C: int,
    L: int,
    ch_ubit: np.ndarray | None = None,
):
    NBt = widx.shape[0]
    NB = NBt // C
    # mirror the C++ unpacker's wire validations (frontend.cpp
    # vp_unpack_pcm): a malformed wire must fail loudly on this path
    # too, never return silently truncated PCM
    if C <= 0 or NBt % C != 0:
        raise ValueError(f"dpack wire geometry invalid: nbt={NBt} C={C}")
    if NB * BLOCK < L:
        raise ValueError(f"dpack wire covers {NB * BLOCK} < L={L} samples")
    wclass = (widx & 0x1F).astype(np.int64)
    if wclass.size and int(wclass.max()) >= len(WIDTHS):
        raise ValueError(
            f"dpack width class {int(wclass.max())} out of range"
        )
    ord3 = ((widx >> 5) & 1).astype(bool)
    ws = np.asarray(WIDTHS, dtype=np.int64)
    bpb = ws[wclass] * BLOCK // 8  # bytes per block
    boff = np.cumsum(bpb) - bpb
    z = np.zeros((NBt, BLOCK), dtype=np.int64)
    for wi, w in enumerate(WIDTHS):
        if w == 0:
            continue
        sel = np.nonzero(wclass == wi)[0]
        if sel.size == 0:
            continue
        nb = w * BLOCK // 8
        idx = (boff[sel][:, None] + np.arange(nb)).reshape(-1)
        by = packed[idx]
        bits = np.unpackbits(by, bitorder="little").reshape(
            sel.size, BLOCK, w
        )
        vals = (bits.astype(np.int64) << np.arange(w, dtype=np.int64)).sum(
            axis=2
        )
        z[sel] = vals
    # rice blocks: merge the unary-coded high parts (bit 7; the k-bit
    # low plane decoded above). The unary section follows the planes;
    # each rice sample is q zeros + a 1 terminator, channel cuts from
    # ch_ubit. Validated exactly: terminator counts must match the rice
    # sample counts and each channel's last terminator must close its
    # segment — a corrupt stream fails loudly, never desyncs silently.
    rice = ((widx >> 7) & 1).astype(bool)
    if rice.any():
        if ch_ubit is None or np.asarray(ch_ubit).size != C:
            raise ValueError("dpack rice wire requires per-channel "
                             "unary cuts (ch_ubit)")
        ch_ubit = np.asarray(ch_ubit).astype(np.int64)
        plane_true = int(boff[-1] + bpb[-1])
        ubits = int(ch_ubit[-1])
        ubytes = 4 * ((ubits + 31) // 32)
        if plane_true + ubytes > packed.shape[0]:
            raise ValueError(
                f"dpack payload {packed.shape[0]} B short of plane "
                f"{plane_true} B + unary {ubytes} B"
            )
        ubits_all = np.unpackbits(
            packed[plane_true : plane_true + ubytes], bitorder="little"
        )
        riceC = rice.reshape(C, NB)
        for c in range(C):
            s = int(ch_ubit[c - 1]) if c else 0
            e = int(ch_ubit[c])
            pos = np.flatnonzero(ubits_all[s:e])
            n_rice = int(riceC[c].sum()) * BLOCK
            # each rice block: 128 terminators, then the cursor rounds
            # up to the next u32 word (block-local device construction).
            # Validate exactly: terminator count, the final block's
            # rounded end landing on the channel cut, and no negative
            # gaps (a terminator inside another block's padding).
            if pos.size != n_rice or (
                n_rice and -(-(int(pos[-1]) + 1) // 32) * 32 != e - s
            ):
                raise ValueError(
                    f"dpack unary stream of channel {c} is corrupt: "
                    f"{pos.size} terminators for {n_rice} rice samples"
                )
            if not n_rice:
                continue
            nrb = n_rice // BLOCK
            block_ends = pos[BLOCK - 1 :: BLOCK]
            starts = np.zeros(nrb, dtype=np.int64)
            starts[1:] = ((block_ends[:-1] + 32) >> 5) << 5
            qs = np.diff(np.concatenate(([-1], pos))) - 1
            firsts = np.arange(nrb) * BLOCK
            qs[firsts] = pos[firsts] - starts
            if qs.min(initial=0) < 0:
                raise ValueError(
                    f"dpack unary stream of channel {c} is corrupt: "
                    "terminator inside block padding"
                )
            rb = np.flatnonzero(riceC[c])
            rows = c * NB + rb
            z[rows] |= qs.reshape(-1, BLOCK) << ws[wclass[rows]][:, None]
    d = (z >> 1) ^ -(z & 1)  # un-zigzag: signed block values
    d_flat = d.reshape(C, NB * BLOCK)
    f = ord3.reshape(C, NB)
    inter = ((widx >> 6) & 1).astype(bool).reshape(C, NB)

    def chain_d2(v, fl):
        """[K, NB*BLOCK] block values + order-3 flags [K, NB] -> d2.

        Order-3 blocks carry d3: within each RUN of flagged blocks d2 is
        the running sum of d3 seeded by the d2 value just before the run
        (last sample of an order-2 block — whose value IS its d2 — or 0
        at channel start)."""
        if not fl.any():
            return v
        K = v.shape[0]
        f_s = np.repeat(fl, BLOCK, axis=1)
        S = np.cumsum(v * f_s, axis=1)
        first = fl & ~np.concatenate(
            [np.zeros((K, 1), bool), fl[:, :-1]], axis=1
        )
        startb = np.maximum.accumulate(
            np.where(first, np.arange(NB)[None, :], -1), axis=1
        )
        pre = np.repeat(startb * BLOCK - 1, BLOCK, axis=1)
        valid = pre >= 0
        idx = np.clip(pre, 0, NB * BLOCK - 1)
        base = np.where(valid, np.take_along_axis(v, idx, axis=1), 0)
        s_pre = np.where(valid, np.take_along_axis(S, idx, axis=1), 0)
        return np.where(f_s, base + S - s_pre, v)

    d2 = np.empty_like(d_flat)
    partner = pair_partner(C)
    ind = np.nonzero(partner == np.arange(C))[0]  # stash + unpaired
    d2[ind] = chain_d2(d_flat[ind], f[ind])
    dep = np.nonzero(partner != np.arange(C))[0]
    if dep.size:
        # inter blocks add the pair partner's same-order difference
        d2_p = d2[partner[dep]]
        d3_p = np.diff(d2_p, axis=1, prepend=0)
        f_s = np.repeat(f[dep], BLOCK, axis=1)
        g_s = np.repeat(inter[dep], BLOCK, axis=1)
        v = d_flat[dep] + g_s * np.where(f_s, d3_p, d2_p)
        d2[dep] = chain_d2(v, f[dep])
    q = np.cumsum(np.cumsum(d2, axis=1), axis=1)[:, :L]
    return q.astype(np.int16)
