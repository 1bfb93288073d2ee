"""Device-side floor curve synthesis (JAX/XLA).

Floor1: the reference renders each curve with a serial Bresenham loop
(NVorbis/Floor1.cs:372 RenderLineMulti). Here every output bin is computed
independently from its bracketing *enabled* posts with the exact integer
closed form y = y0 + sign(dy) * floor(|dy| * (x - x0) / (x1 - x0)) — the
same values the spec's err-accumulation loop produces (spec 9.2.7) — so the
whole [frames, half] curve batch is one vectorized VPU pass.

Floor0: LSP product formula (spec 6.2.3; NVorbis/Floor0.cs:164) with the
per-order product unrolled (order is static per floor config).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(1 << 30)


@partial(jax.jit, static_argnames=("xs", "multiplier", "half"))
def floor1_curves(
    posts: jax.Array,  # [G, P] int32 — final post Y values, config x order
    step2: jax.Array,  # [G, P] bool — post-enabled flags
    used: jax.Array,  # [G] bool — floor present for this (frame, channel)
    *,
    xs: tuple[int, ...],  # static: post X positions, config order
    multiplier: int,  # static
    half: int,  # static: n // 2
) -> jax.Array:
    """Piecewise-linear floor curves -> [G, half] float32 (linear domain)."""
    P = len(xs)
    xs_np = np.asarray(xs, dtype=np.int64)
    sort_order = np.argsort(xs_np, kind="stable")
    xs_s = xs_np[sort_order].astype(np.int32)  # static sorted X
    # static bin -> base post: largest p with xs_s[p] <= x  (xs_s[0] == 0)
    base_p = (np.searchsorted(xs_s, np.arange(half), side="right") - 1).astype(
        np.int32
    )

    order = jnp.asarray(sort_order)
    y_s = jnp.take(posts, order, axis=1).astype(jnp.int32) * multiplier
    en_s = jnp.take(step2, order, axis=1)

    idx = jnp.arange(P, dtype=jnp.int32)
    # lo[p] = largest enabled q <= p ; hi[p] = smallest enabled q > p
    lo = jax.lax.cummax(jnp.where(en_s, idx, -1), axis=1)
    rmin = jax.lax.cummin(jnp.where(en_s, idx, _BIG), axis=1, reverse=True)
    hi = jnp.concatenate(
        [rmin[:, 1:], jnp.full((rmin.shape[0], 1), _BIG, dtype=rmin.dtype)], axis=1
    )
    hi = jnp.minimum(hi, P)  # keep the "none" sentinel matmul-exact

    # Gather-free expansion: every bin-indexed lookup is a one-hot
    # contraction (chosen where dynamic gathers were slow; on the GPU
    # plain gathers are a measured decision left to a later change). All
    # values involved are small integers — exact in float32 at HIGHEST.
    sel = jnp.asarray(
        (base_p[:, None] == np.arange(P)[None, :]).astype(np.float32)
    )  # [half, P] static: bin -> base post
    hp = jax.lax.Precision.HIGHEST
    lo_b = jnp.matmul(lo.astype(jnp.float32), sel.T, precision=hp).astype(
        jnp.int32
    )
    hi_b = jnp.matmul(hi.astype(jnp.float32), sel.T, precision=hp).astype(
        jnp.int32
    )
    # posts[0] (x = 0) is always enabled for a used floor, so lo_b >= 0
    lo_b = jnp.maximum(lo_b, 0)
    has_hi = hi_b < P
    hi_c = jnp.where(has_hi, hi_b, 0)

    pr = jnp.arange(P, dtype=jnp.int32)
    oh_lo = (lo_b[..., None] == pr).astype(jnp.float32)  # [G, half, P]
    oh_hi = (hi_c[..., None] == pr).astype(jnp.float32)
    xs_f = jnp.asarray(xs_s.astype(np.float32))
    y_f = y_s.astype(jnp.float32)
    x0 = jnp.einsum("ghp,p->gh", oh_lo, xs_f, precision=hp).astype(jnp.int32)
    x1 = jnp.where(
        has_hi,
        jnp.einsum("ghp,p->gh", oh_hi, xs_f, precision=hp).astype(jnp.int32),
        x0,
    )
    y0 = jnp.einsum("ghp,gp->gh", oh_lo, y_f, precision=hp).astype(jnp.int32)
    y1 = jnp.einsum("ghp,gp->gh", oh_hi, y_f, precision=hp).astype(jnp.int32)

    x = jnp.arange(half, dtype=jnp.int32)[None, :]
    dy = y1 - y0
    adx = jnp.maximum(x1 - x0, 1)
    off = (jnp.abs(dy) * (x - x0)) // adx
    val = jnp.where(has_hi, y0 + jnp.sign(dy) * off, y0)
    val = jnp.clip(val, 0, 255)

    # inverse-dB lookup as a 16x16 factored one-hot product:
    # table[v] == A[v >> 4] * B[v & 15] to within 1 float32 ulp
    a_tab = jnp.asarray(
        (10.0 ** (7.0 * 16.0 * np.arange(16, dtype=np.float64) / 256.0)).astype(
            np.float32
        )
    )
    b_tab = jnp.asarray(
        (
            10.0 ** ((7.0 * np.arange(16, dtype=np.float64) - 7.0 * 255.0) / 256.0)
        ).astype(np.float32)
    )
    h16 = jnp.arange(16, dtype=jnp.int32)
    oh_h = ((val >> 4)[..., None] == h16).astype(jnp.float32)
    oh_l = ((val & 15)[..., None] == h16).astype(jnp.float32)
    curve = jnp.einsum("ghp,p->gh", oh_h, a_tab, precision=hp) * jnp.einsum(
        "ghp,p->gh", oh_l, b_tab, precision=hp
    )
    return jnp.where(used[:, None], curve, 0.0)


@partial(jax.jit, static_argnames=("xs", "multiplier"))
def floor1_unwrap(
    ys: jax.Array,  # [G, P] int32 — coded values (bitstream prediction
    #                 residuals), config x order; 0 where no subclass book
    *,
    xs: tuple[int, ...],  # static: post X positions, config order
    multiplier: int,  # static
) -> tuple[jax.Array, jax.Array]:
    """Amplitude value synthesis on device (spec 7.2.2 step 2).

    Bit-exact mirror of ``setup/floor.py Floor1._unwrap`` (the reference's
    ``Floor1.UnwrapPosts``, NVorbis/Floor1.cs:270), vectorized over G
    rows: the low/high neighbor tables and X positions are static per
    floor config, so the cascade unrolls into <= 63 steps of elementwise
    int32 ops on [G] columns — no gathers, no dynamic indexing. Shipping
    the coded values instead of unwrapped posts+step2 cuts the floor1
    wire roughly in half (posts u8 + step2 bits -> ys nibbles).

    All intermediates fit int32 when ys <= 255 (the nibble+escape wire's
    own cap, enforced statically by the subclass-book gate in
    models/pipeline.py): predicted stays within [-256, 511] and the
    render_point product |dy| * (x - x0) <= ~767 * 32768.

    Returns (posts [G, P] int32 clamped to the floor range, step2 [G, P]
    bool).
    """
    P = len(xs)
    xs_np = np.asarray(xs, dtype=np.int64)
    rng = (256, 128, 86, 64)[multiplier - 1]
    # static neighbor tables (same derivation as Floor1.__init__)
    low_nb = [0] * P
    high_nb = [0] * P
    for i in range(2, P):
        below = [j for j in range(i) if xs_np[j] < xs_np[i]]
        above = [j for j in range(i) if xs_np[j] > xs_np[i]]
        low_nb[i] = max(below, key=lambda j: xs_np[j])
        high_nb[i] = min(above, key=lambda j: xs_np[j])

    ysc = ys.astype(jnp.int32)
    G = ysc.shape[0]
    true_col = jnp.ones((G,), dtype=bool)
    final = [ysc[:, 0], ysc[:, 1]]
    step2 = [true_col, true_col] + [None] * (P - 2)
    for i in range(2, P):
        lo, hi = low_nb[i], high_nb[i]
        y0, y1 = final[lo], final[hi]
        # render_point with static x geometry (spec 9.2.6)
        dy = y1 - y0
        adx = int(xs_np[hi] - xs_np[lo])
        dx = int(xs_np[i] - xs_np[lo])
        off = (jnp.abs(dy) * dx) // adx
        predicted = jnp.where(dy < 0, y0 - off, y0 + off)
        val = ysc[:, i]
        highroom = rng - predicted
        lowroom = predicted
        room = 2 * jnp.minimum(highroom, lowroom)
        big = jnp.where(
            highroom > lowroom,
            val - lowroom + predicted,
            predicted - val + highroom - 1,
        )
        small = jnp.where(
            (val & 1) == 1,
            predicted - ((val + 1) >> 1),
            predicted + (val >> 1),
        )
        nz = val != 0
        final.append(
            jnp.where(nz, jnp.where(val >= room, big, small), predicted)
        )
        step2[i] = nz
        step2[lo] = step2[lo] | nz
        step2[hi] = step2[hi] | nz
    posts = jnp.clip(jnp.stack(final, axis=1), 0, rng - 1)
    return posts, jnp.stack(step2, axis=1)


@partial(
    jax.jit,
    static_argnames=(
        "order", "bark_map", "bark_map_size", "amplitude_bits", "amplitude_offset",
    ),
)
def floor0_curves(
    coefficients: jax.Array,  # [G, order] float32 LSP coefficients
    amplitude: jax.Array,  # [G] int32
    used: jax.Array,  # [G] bool
    *,
    order: int,
    bark_map: tuple[int, ...],  # static: [half] bark bin map for this blocksize
    bark_map_size: int,
    amplitude_bits: int,
    amplitude_offset: int,
) -> jax.Array:
    """LSP floor curves -> [G, half] float32 (linear domain)."""
    m = np.asarray(bark_map, dtype=np.float64)
    cos_w = jnp.asarray(
        np.cos(np.pi * m / bark_map_size).astype(np.float32)
    )  # [half]
    cos_c = jnp.cos(coefficients)  # [G, order]

    half = len(bark_map)
    ones = jnp.ones((coefficients.shape[0], half), dtype=jnp.float32)
    p = ones
    q = ones
    # unrolled static-order product (libvorbis computes these in f32 too)
    for j in range(order):
        t = 4.0 * jnp.square(cos_c[:, j : j + 1] - cos_w[None, :])
        if j % 2 == 1:
            p = p * t
        else:
            q = q * t
    if order % 2 == 1:
        p = p * (1.0 - jnp.square(cos_w))[None, :]
        q = q * 0.25
    else:
        p = p * ((1.0 - cos_w) * 0.5)[None, :]
        q = q * ((1.0 + cos_w) * 0.5)[None, :]

    denom = jnp.sqrt(p + q)
    denom = jnp.where(denom == 0.0, 1e-9, denom)
    amp_max = (1 << amplitude_bits) - 1
    amp = amplitude.astype(jnp.float32)[:, None]
    exponent = 0.11512925 * (
        amp * amplitude_offset / (amp_max * denom) - amplitude_offset
    )
    # well-formed streams keep curves O(1); clamp so degenerate LSP input
    # (near-coincident roots) saturates instead of producing inf in f32
    linear = jnp.exp(jnp.minimum(exponent, 80.0))
    return jnp.where(used[:, None], linear, 0.0)
