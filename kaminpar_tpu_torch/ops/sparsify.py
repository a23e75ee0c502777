"""Edge sparsification on the device (counterpart of
kaminpar_tpu/ops/sparsify.py; the reference's
SparsificationClusterCoarsener, linear-time MGP, arXiv 2504.17615).

One hashed coin per undirected edge (both directions hash the unordered
endpoint pair, so the graph stays symmetric) drops the edge with
probability 1 - keep_ratio; a dropped edge keeps its slot and its src (the
row spans stay exact) but points at the pad node with weight 0, inert in
ratings, cuts and contractions; kept edge weights are scaled by
1 / keep_ratio, so expected cut weights are preserved.

The arithmetic is the JAX package's: the pair key lo * 1_000_003 + hi
wraps in int32 (here computed in int64; hash_u32 reads its low 32 bits),
the threshold and the weight scaling are float32, and rounding is half to
even (torch.round, like jnp.round).
"""

from __future__ import annotations

import torch

from ..graphs.csr import DeviceGraph
from .segments import hash_u32

# the largest float32 below 2**31
_F32_BELOW_2_31 = 2147483392.0


def sparsify_edges(graph: DeviceGraph, keep_ratio: float,
                   salt: int) -> DeviceGraph:
    """Drop each undirected edge with probability 1 - keep_ratio."""
    pad_node = graph.n_pad - 1
    dev = graph.device
    lo = torch.minimum(graph.src, graph.dst).to(torch.int64)
    hi = torch.maximum(graph.src, graph.dst).to(torch.int64)
    h = hash_u32(lo * 1_000_003 + hi, salt)
    ratio = torch.tensor(keep_ratio, dtype=torch.float32, device=dev)
    thresh = torch.minimum(
        ratio * torch.tensor(2147483647.0, dtype=torch.float32, device=dev),
        torch.tensor(_F32_BELOW_2_31, dtype=torch.float32, device=dev),
    ).to(torch.int32)
    keep = (h < thresh) | (ratio >= 1.0)
    is_real = graph.src < graph.n
    drop = is_real & ~keep

    scale = 1.0 / torch.clamp(ratio, min=1e-6)
    new_w = torch.round(graph.edge_w.to(torch.float32) * scale).clamp(
        0, _F32_BELOW_2_31
    ).to(graph.edge_w.dtype)
    return DeviceGraph(
        row_ptr=graph.row_ptr,
        src=graph.src,
        dst=torch.where(drop, pad_node, graph.dst),
        edge_w=torch.where(drop | ~is_real, 0, new_w),
        node_w=graph.node_w,
        n=graph.n,
        m=graph.m,
    )
