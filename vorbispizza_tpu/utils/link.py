"""Device->host link-rate estimate for wire-format selection.

The rice PCM wire trades device exec for fewer wire bytes; that trade
pays only on links slower than ``config.s16_rice_threshold_mbps``.
``d2h_rate_estimate`` measures the link ONCE per process (the best of a
few 16 MB pulls of computed data) so ``config.s16_rice="auto"`` can pick
per deployment.
A failed measurement raises: a guessed rate would silently pick the
wire for the whole process.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_cached: float | None = None
#: bytes per timed pull, and timed pulls after one warm-up pull
_PROBE_BYTES = 16 << 20
_PROBE_PULLS = 3


def d2h_rate_estimate(force: float | None = None) -> float:
    """Measured device->host rate in bytes/s, cached per process.

    CPU backends (host == device, tests) return +inf without measuring.
    ``force`` overrides the cache and ``reset()`` clears it (tests)."""
    global _cached
    if force is not None:
        with _lock:
            _cached = force
        return force
    if _cached is not None:
        return _cached
    with _lock:
        if _cached is not None:
            return _cached
        import jax
        import numpy as np

        if jax.default_backend() == "cpu":
            _cached = float("inf")
            return _cached
        # computed payloads whose bytes look random (int16 wrapping
        # multiply), so a link that compresses in flight cannot inflate
        # the measured rate; each pull is a fresh array (a jax Array
        # caches its host copy), the first is a warm-up, and the best of
        # the rest is kept, so per-pull set-up costs weigh little
        x = jax.device_put(
            np.random.default_rng(0).integers(
                -30000, 30000, size=(_PROBE_BYTES // 2,), dtype=np.int16
            )
        )
        best = 0.0
        for k in range(_PROBE_PULLS + 1):
            y = x * np.int16(31337 + 2 * k) + np.int16(77)
            y.block_until_ready()
            t0 = time.perf_counter()
            np.asarray(y)
            dt = time.perf_counter() - t0
            if k:
                best = max(best, y.nbytes / dt if dt > 0 else float("inf"))
        _cached = best
        return _cached


def reset() -> None:
    """Forget the cached rate (tests)."""
    global _cached
    with _lock:
        _cached = None
