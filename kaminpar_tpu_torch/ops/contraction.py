"""Cluster contraction (counterpart of kaminpar_tpu/ops/contraction.py).

Given per-node cluster labels, build the coarse graph whose nodes are the
clusters and whose edges aggregate inter-cluster edge weights: dense ids
by mark + prefix sum, coarse node weights by segment sum, coarse edge
endpoints (cmap[src], cmap[dst]) with self-loops and pad edges routed to a
sentinel, one sorted segmented aggregation, then one host readback of the
coarse counts to pick the coarse pad bucket and rebuild row_ptr.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..caching import pad_size
from ..dtypes import ACC_DTYPE
from ..graphs.csr import DeviceGraph, shape_floors
from .gather import gather_i32
from .segments import aggregate_by_key, segment_min, segment_sum


@dataclass
class CoarseGraph:
    """A coarse graph plus the fine -> coarse projection map."""

    graph: DeviceGraph
    cmap: torch.Tensor  # i32[n_pad_fine]: coarse node id of each fine node

    def project_up(self, coarse_partition: torch.Tensor) -> torch.Tensor:
        """Coarse partition -> fine partition."""
        return gather_i32(coarse_partition, self.cmap)

    def project_down(self, fine_partition: torch.Tensor) -> torch.Tensor:
        """Fine partition -> coarse partition: each coarse node takes the
        block of its lowest fine node (consistent only where the fine
        partition is constant on every cluster)."""
        n_fine = self.cmap.shape[0]
        first_fine = segment_min(
            torch.arange(n_fine, dtype=torch.int32, device=self.cmap.device),
            self.cmap, self.graph.n_pad,
        )
        return fine_partition[first_fine.clamp(0, n_fine - 1).to(torch.int64)]


def _fit(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    if size <= x.shape[0]:
        return x[:size]
    return torch.cat([x, x.new_full((size - x.shape[0],), fill)])


def contract_clustering(
    graph: DeviceGraph, labels: torch.Tensor
) -> Tuple[CoarseGraph, int, int]:
    """Contract `labels` over `graph`; returns (CoarseGraph, c_n, c_m).
    A `device-oom` fault site (the largest fresh buffers of a level)."""
    from ..resilience.faults import maybe_inject

    maybe_inject("device-oom")
    n_pad = graph.n_pad
    dev = graph.device
    node_ids = graph.node_ids()
    is_real = node_ids < graph.n

    # dense coarse ids (fill_leader_mapping + prefix sum analog)
    lab = labels.clamp(0, n_pad - 1)
    used = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    used.scatter_reduce_(0, lab.to(torch.int64), is_real.to(torch.int32),
                         "amax", include_self=True)
    rank = torch.cumsum(used, 0, dtype=torch.int32) - used
    cmap = torch.where(is_real, rank[lab], -1)
    c_n_t = used.sum(dtype=torch.int32)
    c_node_w = segment_sum(
        torch.where(is_real, graph.node_w, 0).to(ACC_DTYPE),
        cmap.clamp(0, n_pad - 1),
        n_pad,
    )

    # coarse edges; self-loops and pad edges go to the sentinel n_pad
    sentinel = n_pad
    cu = torch.where(graph.src < graph.n,
                     gather_i32(cmap, graph.src.clamp(0, n_pad - 1)),
                     sentinel)
    cv = torch.where(graph.dst < graph.n,
                     gather_i32(cmap, graph.dst.clamp(0, n_pad - 1)),
                     sentinel)
    valid = (cu != cv) & (cu < sentinel) & (cv < sentinel)
    cu = torch.where(valid, cu, sentinel)
    cv = torch.where(valid, cv, sentinel)
    w = torch.where(valid, graph.edge_w, 0)
    cu_g, cv_g, w_g = aggregate_by_key(cu, cv, w)
    group_valid = (cu_g >= 0) & (cu_g < sentinel)
    c_n, c_m = (
        int(v) for v in
        torch.stack([c_n_t, group_valid.sum(dtype=torch.int32)]).tolist()
    )

    n_floor, m_floor = shape_floors()
    n_pad_c = pad_size(c_n + 1, n_floor)
    m_pad_c = pad_size(max(c_m, 1), m_floor)
    pad_node = n_pad_c - 1
    in_range = torch.arange(m_pad_c, dtype=torch.int32, device=dev) < c_m
    src_c = torch.where(in_range, _fit(cu_g, m_pad_c, 0), pad_node)
    dst_c = torch.where(in_range, _fit(cv_g, m_pad_c, 0), pad_node)
    w_c = torch.where(in_range, _fit(w_g, m_pad_c, 0), 0).to(ACC_DTYPE)
    counts = segment_sum(
        in_range.to(torch.int32), src_c.clamp(0, n_pad_c - 1), n_pad_c
    )
    node_c = torch.arange(n_pad_c, dtype=torch.int32, device=dev) < c_n
    counts = torch.where(node_c, counts, 0)
    row_ptr = torch.cat([
        counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)
    ])
    node_w_c = torch.where(node_c, _fit(c_node_w, n_pad_c, 0), 0)
    cmap_final = torch.where(cmap >= 0, cmap, pad_node).to(torch.int32)
    coarse = DeviceGraph(
        row_ptr=row_ptr,
        src=src_c.to(torch.int32),
        dst=dst_c.to(torch.int32),
        edge_w=w_c,
        node_w=node_w_c.to(ACC_DTYPE),
        n=c_n,
        m=c_m,
    )
    return CoarseGraph(graph=coarse, cmap=cmap_final), c_n, c_m
