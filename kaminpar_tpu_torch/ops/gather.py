"""Edge-wide gathers: kernels K1 and K2 (counterpart of ops/lane_gather.py).

The JAX package's TPU kernel `lane_gather` exists because a TPU lane can
only read its own column: it plans a routing of the static index array
(graph.dst) once per level and gathers in routed slot order.  On Hopper
any thread reads any address, so the plan is not ported and both kernels
here work in edge order:

  * K1 `gather_i32(table, idx)`: out[e] = table[idx[e]] — every
    level-wide labels[dst], part[dst] and cmap[dst] on the path;
  * K2 `dense_block_ratings(row_start, row_end, dst, w, labels, n_pad,
    k)`: the fused block lookup + accumulation of an (n_pad, k)
    connection table that `routed_block_ratings` and
    `segments.dense_block_ratings` compute; each row's edges are its CSR
    span, so the kernel reads no per-edge source.

Each wrapper takes its plain torch twin only for CPU tensors; on a CUDA
tensor it launches the hand-written kernel (csrc/) or raises.  `launches`
on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import _native

# KAMINPAR_TPU_TORCH_DEBUG=1 makes gather_i32 check its indices on the
# host before a launch (one reduction + readback per call)
DEBUG_ENV = "KAMINPAR_TPU_TORCH_DEBUG"

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong

# K2 indexes slots in int32, with a block's step of headroom
MAX_RATING_SLOTS = (1 << 31) - (1 << 16)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_i32_on(device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------


def gather_i32_twin(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1."""
    return table[idx]


def gather_i32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[e] = table[idx[e]] (int32, edge order).  Indices must lie in
    [0, len(table)): callers clip exactly where the JAX package clips."""
    if table.device.type == "cpu":
        return gather_i32_twin(table, idx)
    table = table.contiguous()
    idx = idx.contiguous()
    _require_i32_on(table.device, table, idx)
    if os.environ.get(DEBUG_ENV, "") == "1" and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= table.numel():
            raise IndexError(
                f"gather_i32: index range [{lo}, {hi}] outside "
                f"[0, {table.numel()})"
            )
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    fn = _native.bind("gather.cu", "kp_gather_i32", (_VP, _VP, _VP, _LL, _VP))
    with _native.timed("gather_i32"):
        code = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  idx.numel(), _stream())
    _native.check(code, "gather_i32")
    gather_i32.launches += 1
    return out


gather_i32.launches = 0


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------


def span_slots(row_start: torch.Tensor, row_end: torch.Tensor, slots: int,
               n_pad: int):
    """Every buffer slot of each row's span [row_start[u], row_end[u]),
    clipped to [0, slots), in row order: (row i64, slot i64, span length
    i64[n_pad]).  What the span kernels (K2, the fused K3) read."""
    end = row_end.to(torch.int64).clamp(0, slots)
    start = torch.minimum(row_start.to(torch.int64).clamp(0, slots), end)
    length = end - start
    dev = row_end.device
    rows = torch.repeat_interleave(
        torch.arange(n_pad, dtype=torch.int64, device=dev), length
    )
    first = torch.cumsum(length, 0) - length
    slot = torch.arange(rows.shape[0], dtype=torch.int64, device=dev) + (
        start - first
    )[rows]
    return rows, slot, length


def dense_block_ratings_twin(
    row_start: torch.Tensor,
    row_end: torch.Tensor,
    dst: torch.Tensor,
    edge_w: torch.Tensor,
    labels: torch.Tensor,
    n_pad: int,
    num_blocks: int,
) -> torch.Tensor:
    """Plain torch version of K2 (segments.dense_block_ratings): each
    slot's row comes from the clipped spans."""
    rows, slot, _ = span_slots(row_start, row_end, dst.shape[0], n_pad)
    lab_c = labels.clamp(0, num_blocks - 1)
    flat = rows * num_blocks + lab_c[dst[slot]].to(torch.int64)
    conn = torch.zeros(n_pad * num_blocks, dtype=torch.int32,
                       device=dst.device)
    conn.index_add_(0, flat, edge_w[slot].to(torch.int32))
    return conn.view(n_pad, num_blocks)


def dense_block_ratings(
    row_start: torch.Tensor,
    row_end: torch.Tensor,
    dst: torch.Tensor,
    edge_w: torch.Tensor,
    labels: torch.Tensor,
    n_pad: int,
    num_blocks: int,
) -> torch.Tensor:
    """Exact (n_pad, k) connection table: conn[u, clip(labels[dst[e]], 0,
    k-1)] += edge_w[e] over the slots e of row u's span [row_start[u],
    row_end[u]), clipped to [0, len(dst)).  The spans are in row order and
    do not overlap (CSR offsets, or expand_active_rows' start and end).
    The label table may be longer than the rows (a dist shard's owned
    labels then its ghosts); dst must index it."""
    if dst.device.type == "cpu":
        return dense_block_ratings_twin(
            row_start, row_end, dst, edge_w, labels, n_pad, num_blocks
        )
    row_start, row_end, dst, edge_w, labels = (
        t.contiguous() for t in (row_start, row_end, dst, edge_w, labels)
    )
    _require_i32_on(dst.device, row_start, row_end, dst, edge_w, labels)
    if dst.shape != edge_w.shape:
        raise ValueError("dst and edge_w must have one shape")
    if not (row_start.shape == row_end.shape == (n_pad,)):
        raise ValueError("row_start and row_end must have n_pad entries")
    if labels.dim() != 1 or labels.numel() < 1 or (
        labels.numel() >= 2**31
    ):
        raise ValueError("labels must be a non-empty table below 2^31 "
                         "entries")
    slots = dst.numel()
    if slots > MAX_RATING_SLOTS:
        raise ValueError(f"dense_block_ratings: {slots} slots exceed the "
                         f"kernel's int32 slot index")
    blocks = _native.bind(
        "dense_ratings.cu", "kp_dense_block_ratings_blocks",
        (_LL, _LL, ctypes.c_int), restype=_LL,
    )(n_pad, slots, int(num_blocks))
    conn = torch.empty((n_pad, num_blocks), dtype=torch.int32,
                       device=dst.device)
    plan = torch.empty(2 * (blocks + 1), dtype=torch.int32,
                       device=dst.device)
    fn = _native.bind(
        "dense_ratings.cu", "kp_dense_block_ratings",
        (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, ctypes.c_int,
         _LL, _VP),
    )
    with _native.timed("dense_block_ratings"):
        code = fn(row_start.data_ptr(), row_end.data_ptr(), dst.data_ptr(),
                  edge_w.data_ptr(), labels.data_ptr(), conn.data_ptr(),
                  plan.data_ptr(), n_pad, labels.numel(), slots,
                  int(num_blocks), blocks, _stream())
    _native.check(code, "dense_block_ratings")
    dense_block_ratings.launches += 1
    return conn


dense_block_ratings.launches = 0
