"""Distributed quality metrics (counterpart of
kaminpar_tpu/parallel/dist_metrics.py): each shard sums the weight of its
cut edges, the sums are psum'd, and every undirected edge (stored once
per endpoint) counts twice."""

from __future__ import annotations

import torch

from ..dtypes import ACC_DTYPE
from ..ops.gather import gather_i32
from .dist_graph import DistGraph
from .mesh import psum


def dist_edge_cut(graph: DistGraph, labels) -> int:
    """Edge cut of a replicated labeling [n_pad] over the sharded graph."""
    home = graph.mesh.device
    labels = torch.as_tensor(labels).to(home).to(torch.int32)
    cuts = []
    for sh in graph.shards():
        lab = labels.to(sh.src.device)
        cut = gather_i32(lab, sh.src) != gather_i32(lab, sh.dst)
        cuts.append(torch.where(cut, sh.edge_w, 0).sum(dtype=ACC_DTYPE))
    return int(psum(cuts, device=home)) // 2
