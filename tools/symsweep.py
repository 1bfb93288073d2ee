"""Size candidate packings for the residue SYMBOL wire.

Symbols are the largest residual h2d term (~51%: fixed w-bit entry
numbers per (submap, pass, book) group + w_i-bit scatter indices). This
sizes, against the bench corpus family, per stream group:

  current    w = ceil(log2(entries+1)) bits per symbol (the sentinel
             ``entries`` must stay encodable)
  remap+blk  static frequency-ranked remap per book (host remaps, device
             un-remaps via its VQ row table — free: the table rows can be
             permuted once per setup), then per-16-symbol blocks coded at
             the rung holding the block's max rank (rung index nibble per
             block) — the dpack idea applied to ranks
  entropy    the Huffman codeword lengths the bitstream itself used
             (floor; requires sequential bit parse, not shippable as-is)

Run: PYTHONPATH=. python tools/symsweep.py
"""

from __future__ import annotations

import numpy as np

from vorbispizza_tpu.models.corpus import _front_end, merge_streams
from vorbispizza_tpu.testing.encode import encode_vorbis, make_signal

RUNGS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)


def rung_bits(maxv: np.ndarray) -> np.ndarray:
    need = np.zeros(maxv.shape, dtype=np.int64)
    for r in RUNGS[:-1]:
        need += maxv > ((1 << r) - 1)
    return np.asarray(RUNGS, dtype=np.int64)[need]


def main() -> None:
    rate = 44100
    srcs = [
        encode_vorbis(
            make_signal(2, 15.0, rate=rate, kind="music", seed=s),
            rate=rate,
            quality=0.5,
        )
        for s in range(8)
    ]
    fronts = [_front_end(c) for c in srcs]
    plan, buckets, lens = merge_streams([f[2:4] for f in fronts])

    setup = fronts[0][0]

    cur_bits = 0
    remap_emp_bits = 0
    remap_len_bits = 0
    n_syms = 0
    # class variants: partitions (nsym symbols each) re-grouped into R
    # static width classes; syms of class c packed at w_c bits. The
    # device scatter-add is order-free, so class re-grouping ships no
    # extra indices (slots travel with their partitions). Padding: each
    # class pads partitions to a 16-partition quantum.
    cls_bits = {2: 0, 3: 0}
    for b in buckets:
        if b.sym is None:
            continue
        for g, stream in zip(b.sym.groups, b.sym.syms):
            if stream.size == 0:
                continue
            w = max(int(g.entries).bit_length(), 1)
            cur_bits += stream.size * w
            n_syms += stream.size
            # empirical frequency rank (per chunk; NOT shippable — needs
            # a per-chunk table) vs static codeword-length rank (free:
            # permute the VQ row table once per setup)
            vals, counts = np.unique(stream, return_counts=True)
            order = np.argsort(-counts, kind="stable")
            rank_of = np.zeros(int(g.entries) + 1, dtype=np.int64)
            rank_of[vals[order]] = np.arange(vals.size)
            ranks_emp = rank_of[stream]

            lens_cw = setup.codebooks[g.book_idx].code_lengths
            used = lens_cw > 0
            key = np.where(used, lens_cw, 99)
            lorder = np.argsort(key, kind="stable")
            lrank = np.empty(int(g.entries) + 1, dtype=np.int64)
            lrank[lorder] = np.arange(lorder.size)
            lrank[g.entries] = int(used.sum())  # sentinel right after used
            # entries ranked past the sentinel shift by one
            lrank[:-1][lrank[:-1] >= lrank[g.entries]] += 1
            ranks_len = lrank[stream]

            for ranks, acc in ((ranks_emp, "emp"), (ranks_len, "len")):
                nb = -(-ranks.size // 16)
                padded = np.zeros(nb * 16, dtype=np.int64)
                padded[: ranks.size] = ranks
                bw = rung_bits(padded.reshape(nb, 16).max(axis=1))
                bits = int(bw.sum()) * 16 + nb * 4
                if acc == "emp":
                    remap_emp_bits += bits
                else:
                    remap_len_bits += bits

            # partition-granularity classes over length-ranks
            npart = stream.size // g.nsym
            pmax = ranks_len[: npart * g.nsym].reshape(npart, g.nsym).max(
                axis=1
            )
            for R in (2, 3):
                if R == 2:
                    rungs = [4, w]
                else:
                    rungs = [2, 6, w]
                done = np.zeros(npart, dtype=bool)
                for r in rungs:
                    sel = (~done) & (pmax <= (1 << r) - 1)
                    done |= sel
                    nsel = int(sel.sum())
                    nsel_pad = -(-max(nsel, 0) // 16) * 16 if nsel else 0
                    cls_bits[R] += nsel_pad * g.nsym * r
                cls_bits[R] += npart * 2  # class tag bits (2b/partition)
    tot_audio = sum(lens) / rate
    print(f"corpus: {tot_audio:.0f} s audio, {n_syms:,} symbols")
    print(f"current wire:       {cur_bits / 8 / 1e6:8.3f} MB "
          f"({cur_bits / max(n_syms, 1):.2f} bits/sym)")
    for name, bits in (
        ("remap(emp)+blk16", remap_emp_bits),
        ("remap(len)+blk16", remap_len_bits),
        ("remap(len)+2cls", cls_bits[2]),
        ("remap(len)+3cls", cls_bits[3]),
    ):
        print(f"{name}:   {bits / 8 / 1e6:8.3f} MB "
              f"({bits / max(n_syms, 1):.2f} bits/sym)  "
              f"saving {100 * (1 - bits / max(cur_bits, 1)):.1f}%")
    # entropy floor from the bitstream's own lengths: approximate with
    # the empirical symbol distribution (>= true Huffman cost)
    ent_bits = 0.0
    for b in buckets:
        if b.sym is None:
            continue
        for stream in b.sym.syms:
            if stream.size == 0:
                continue
            _, counts = np.unique(stream, return_counts=True)
            p = counts / stream.size
            ent_bits += stream.size * float(-(p * np.log2(p)).sum())
    print(f"entropy floor: {ent_bits / 8 / 1e6:8.3f} MB "
          f"({ent_bits / max(n_syms, 1):.2f} bits/sym)")


if __name__ == "__main__":
    main()
