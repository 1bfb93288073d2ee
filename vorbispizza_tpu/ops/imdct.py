"""Batched IMDCT + window (JAX/XLA, matmul formulation).

Replaces the reference's stb-derived 8-step pointer IMDCT
(NVorbis/Mdct.cs:11) with a DCT-IV-by-matmul formulation: the whole batch of
spectra for one blocksize bucket is a single [B*C, half] @ [half, half]
matmul, followed by the standard IMDCT reflection/extension
(pure slicing, fused by XLA into the window multiply).

    y[j] = sum_{k<n/2} X[k] cos(2*pi/n (j + 0.5 + n/4)(k + 0.5))
         = +-DCT-IV_{n/2}(X)[perm(j)]

Numerics: float32 with Precision.HIGHEST (true f32 products and
accumulation — never TF32 on the GPU) to stay inside the 1e-6 budget vs
the float64 scalar anchor (dsp/imdct.py). On the GPU this is an O(n^2)
f32 GEMM outside the tensor cores; an FFT formulation is a measured
decision left to a later change.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=16)
def dct_iv_matrix(m: int) -> tuple[np.ndarray, np.ndarray]:
    """[m, m] matrix D with DCT-IV(x) = x @ D: D[k, j] = cos(pi/m (j+0.5)(k+0.5)).

    Returned as a compensated (hi, lo) float32 pair with hi + lo == D to
    float64 accuracy: two f32 matmuls against it eliminate the basis
    quantization error, leaving only f32 accumulation noise (~2-4e-7 on real
    signals — inside the 1e-6 PCM budget)."""
    k = np.arange(m, dtype=np.float64)[:, None]
    j = np.arange(m, dtype=np.float64)[None, :]
    d = np.cos(np.pi / m * (j + 0.5) * (k + 0.5))
    hi = d.astype(np.float32)
    lo = (d - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def imdct_window_batch(spectra: jax.Array, window: jax.Array) -> jax.Array:
    """Batched IMDCT + window: [..., n//2] spectra -> [..., n] windowed time.

    ``window`` is the full per-frame window vector [n] (zeros / rising slope /
    ones / falling slope / zeros) — static per bucket.
    """
    m = spectra.shape[-1]
    h = m // 2
    hi, lo = dct_iv_matrix(m)
    d = jnp.matmul(
        spectra, jnp.asarray(hi), precision=jax.lax.Precision.HIGHEST
    ) + jnp.matmul(spectra, jnp.asarray(lo), precision=jax.lax.Precision.HIGHEST)
    # IMDCT symmetries (see dsp/imdct.py): y = [d[h:], -d[::-1], -d[:h]]
    y = jnp.concatenate(
        [d[..., h:], -d[..., ::-1], -d[..., :h]], axis=-1
    )
    return y * window
