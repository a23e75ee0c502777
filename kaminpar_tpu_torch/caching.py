"""Shape-bucket padding policy (own copy of kaminpar_tpu/caching.py's
pad_size, pad_k and pad policy scopes).

"bucketed" (the default) pads to the next power of two over a
granularity floor; "tight" (the memory governor's rungs 1-3,
resilience/memory.py) pads to the next granularity multiple only.  The
mode is thread-local and scope-managed, so the default path is unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_pad_mode = threading.local()

PAD_POLICIES = ("bucketed", "tight")


def pad_policy() -> str:
    """The calling thread's active pad policy ("bucketed" by default)."""
    return getattr(_pad_mode, "mode", "bucketed")


@contextmanager
def pad_policy_scope(mode: str):
    """Run a block under a pad policy (the previous one is restored on
    exit)."""
    if mode not in PAD_POLICIES:
        raise ValueError(f"unknown pad policy {mode!r}")
    prev = pad_policy()
    _pad_mode.mode = mode
    try:
        yield
    finally:
        _pad_mode.mode = prev


def pad_size(x: int, granularity: int = 256) -> int:
    """Next power of two, but at least x rounded up to `granularity`; under
    the "tight" policy the next `granularity` multiple.  Both packages pad
    every level identically."""
    if x <= granularity:
        return granularity
    if pad_policy() == "tight":
        return ((x + granularity - 1) // granularity) * granularity
    return 1 << (x - 1).bit_length()


def pad_k(k: int) -> int:
    """The block-count bucket: k rounded up to a power of two (>= 2)."""
    return max(2, 1 << (int(k) - 1).bit_length())
