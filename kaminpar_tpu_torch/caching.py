"""Shape-bucket padding policy (own copy of kaminpar_tpu.caching.pad_size)."""

from __future__ import annotations


def pad_size(x: int, granularity: int = 256) -> int:
    """Next power of two, but at least x rounded up to `granularity` — the
    JAX package's default ("bucketed") policy, kept so both packages pad
    every level identically."""
    if x <= granularity:
        return granularity
    return 1 << (x - 1).bit_length()


def pad_k(k: int) -> int:
    """The block-count bucket: k rounded up to a power of two (>= 2)."""
    return max(2, 1 << (int(k) - 1).bit_length())
