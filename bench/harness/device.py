"""The card a run uses, and the modules it must not have loaded."""

from __future__ import annotations

import shutil
import subprocess
import sys

# top-level module names the benchmark's process must not hold: JAX and
# the JAX package the port was made from (compared whole, so the port,
# ``repro_torch``, is not one of them)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FOREIGN))


def power_limit() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads it, or
    why it could not be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi rc {out.returncode}"
