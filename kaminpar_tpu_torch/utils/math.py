"""Small math helpers (own copy of what the dist layer needs from
kaminpar_tpu/utils/math.py, the analog of kaminpar-common/math.h)."""

from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple
