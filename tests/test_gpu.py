"""Checks that need a GPU. They skip here; on the card run

    python -m pytest tests/ -q -m gpu

The test process itself is held to the CPU (conftest.py), so each check runs
its GPU work in a child process.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    """Environment for a child process on the GPU; skips when JAX sees none."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU visible to JAX")
    return env


@pytest.mark.gpu
def test_chip_smoke_kernels_phase(gpu_env):
    """Every plain-XLA replacement of a former kernel, compiled for the card
    at real widths, against its NumPy float64 reference."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--phases", "kernels"],
        cwd=REPO, env=gpu_env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
