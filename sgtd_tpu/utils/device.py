"""The device a measurement ran on: JAX's view and the card's own."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power.limit`` of every visible NVIDIA card, as nvidia-smi
    reports them (one card per line)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def require_gpu():
    """JAX's first device, which must be a GPU: a measurement never falls
    back to the CPU. Raises SystemExit otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); refusing to measure"
        )
    return dev

