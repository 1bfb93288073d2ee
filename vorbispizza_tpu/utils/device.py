"""The card a measurement runs on: the GPU gate and the card's name.

Measurements (``bench.py``, ``chip_smoke.py``) name the device they ran
on and refuse to run without a GPU: a number taken on the CPU backend is
not a device number.
"""

from __future__ import annotations

import subprocess


def require_gpu(jax, who: str):
    """JAX's first device; exits with a message unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{who}: needs a GPU, but JAX's first device is "
            f"{dev.platform!r} ({dev.device_kind}); there is no CPU fallback"
        )
    return dev


def card_names() -> list[str]:
    """``name, power.limit`` of every card as ``nvidia-smi`` reports them,
    read by a child process that does not import JAX."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
