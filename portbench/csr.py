"""Edge lists to CSR, in torch on the device that holds them.

The generators draw undirected pairs; `pairs_to_csr` drops self-loops,
stores each edge in both directions, drops duplicates (unit weights, as the
configurations state) and returns the row pointers and neighbour ids with
every row sorted.  `to_host` copies them into the arrays a user hands the
partitioner: int64 row pointers, int32 neighbours.
"""

from __future__ import annotations

import numpy as np
import torch


def pairs_to_csr(n: int, src: torch.Tensor, dst: torch.Tensor):
    """(xadj int64 [n + 1], adjncy int64 [m]) of the simple undirected
    graph on n nodes whose edges are the pairs (src[i], dst[i])."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.cat([src * n + dst, dst * n + src])
    del src, dst, keep
    key = torch.unique(key, sorted=True)
    rows = torch.div(key, n, rounding_mode="floor")
    adjncy = key - rows * n
    del key
    xadj = torch.zeros(n + 1, dtype=torch.int64, device=adjncy.device)
    xadj[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return xadj, adjncy


def to_host(xadj: torch.Tensor, adjncy: torch.Tensor):
    """(xadj int64, adjncy int32) as numpy arrays on the host."""
    return (
        xadj.to("cpu").numpy().astype(np.int64, copy=False),
        adjncy.to(torch.int32).to("cpu").numpy(),
    )
