"""The card a run uses: the check that the card is there, and what the
result line says of it."""

from __future__ import annotations

import subprocess
import sys

# forbidden in the process that prints a result: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "kaminpar_tpu")


def require_cards(torch, chips: int) -> None:
    """Exit with code 2, and no result, unless `chips` CUDA cards are
    visible; a run never falls back to the CPU."""
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available; the benchmark "
              "runs only on the card", file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        sys.exit(2)


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_entry(torch, chips: int, peak_bytes: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(chips),
        "memory_peak_bytes": int(peak_bytes),
        "power_limit_w": power_limit_w(),
    }


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: `kaminpar_tpu_torch` is not `kaminpar_tpu`."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)
