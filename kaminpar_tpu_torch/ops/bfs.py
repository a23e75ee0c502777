"""Device BFS distances as segmented reductions (counterpart of
kaminpar_tpu/ops/bfs.py).

The frontier is a whole-graph predicate and one expansion step is one
`segment_min` over the COO edge list.  The JAX package runs the steps
inside `lax.while_loop`; here a host loop runs them and reads one flag
back per step.
"""

from __future__ import annotations

import torch

from ..dtypes import INT32_MAX
from ..graphs.csr import DeviceGraph
from .segments import segment_min

UNREACHED = INT32_MAX


def bfs_hops(graph: DeviceGraph, seeds: torch.Tensor,
             max_hops: int) -> torch.Tensor:
    """Hop distance from the seed set, capped at `max_hops`.

    seeds: i32[s] node ids (entries outside [0, n) are ignored).  Returns
    i32[n_pad]: 0 for seeds, the hop count for nodes reached within the
    cap, UNREACHED (INT32_MAX) otherwise (pad nodes included)."""
    n_pad = graph.n_pad
    dev = graph.device
    is_real = graph.node_ids() < graph.n
    seeds = seeds.to(device=dev, dtype=torch.int32)
    valid_seed = (seeds >= 0) & (seeds < graph.n)
    dist = torch.full((n_pad,), UNREACHED, dtype=torch.int32, device=dev)
    dist.scatter_reduce_(
        0, seeds.clamp(0, n_pad - 1).to(torch.int64),
        torch.where(valid_seed, 0, UNREACHED).to(torch.int32), "amin",
    )
    dist = torch.where(is_real, dist, UNREACHED)
    h = 0
    changed = True
    while h < int(max_hops) and changed:
        in_frontier = dist[graph.src] == h
        cand = torch.where(in_frontier, h + 1, UNREACHED).to(torch.int32)
        # pad edges point at the pad node; is_real masks it back out
        reached = segment_min(cand, graph.dst, n_pad)
        new = torch.where(is_real, torch.minimum(dist, reached), UNREACHED)
        changed = bool((new != dist).any())
        dist = new
        h += 1
    return dist
