"""The plain reference: a partition recounted in NumPy from the benchmark's
own arrays.

It takes the CSR that the benchmark generated (every undirected edge
stored in both directions) and a partition that the program returned, and
recounts what the configuration states about a partition: every label in
[0, k), every block at most floor((1 + epsilon) * ceil(n / k)), and the
cut, the number of edges whose ends lie in different blocks (every node and
edge weighs 1, as the configurations state).  Rows are swept in blocks of
about `BLOCK_EDGES` edges so that the recount fits beside the window's
partitions.  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

BLOCK_EDGES = 1 << 24


def block_cap(total_node_weight: int, k: int, epsilon: float) -> int:
    """The largest weight a block may have: (1 + epsilon) * ceil(c(V) / k),
    rounded down."""
    return int((1.0 + epsilon) * math.ceil(total_node_weight / k))


def recount(xadj: np.ndarray, adjncy: np.ndarray, part, k: int) -> dict:
    """Labels out of range, block weights, cut and total edge weight (both
    undirected, unit weights as the configurations state) of `part`.  A
    partition of the wrong length has all n labels out of range and no
    cut."""
    n = len(xadj) - 1
    part = np.asarray(part)
    total_ew = len(adjncy) // 2
    if part.shape != (n,):
        return {"out_of_range": n, "block_weights": np.zeros(k, np.int64),
                "cut": None, "total_edge_weight": total_ew}
    labels = part.astype(np.int64)
    out_of_range = int(np.count_nonzero((labels < 0) | (labels >= k)))
    block_weights = np.bincount(np.clip(labels, 0, k - 1), minlength=k)
    cut2 = 0
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(xadj, xadj[r0] + BLOCK_EDGES, side="right")) - 1
        r1 = min(n, max(r1, r0 + 1))
        e0, e1 = int(xadj[r0]), int(xadj[r1])
        own = np.repeat(labels[r0:r1], np.diff(xadj[r0:r1 + 1]))
        cut2 += int(np.count_nonzero(own != labels[adjncy[e0:e1]]))
        r0 = r1
    return {"out_of_range": out_of_range,
            "block_weights": block_weights.astype(np.int64),
            "cut": cut2 // 2, "total_edge_weight": total_ew}


def judge(counted: dict, k: int, epsilon: float, total_node_weight: int,
          reported_cut: Optional[int]) -> dict:
    """The numbers `correct` compares for one partition: labels out of
    range, the heaviest block's weight over the cap (<= 0 when balanced),
    the gap between the cut the program reported and the recount, and the
    cut's share of the edge weight."""
    cap = block_cap(total_node_weight, k, epsilon)
    cut = counted["cut"]
    gap = 0
    if reported_cut is not None:
        gap = abs(int(reported_cut) - cut) if cut is not None else 1
    total = counted["total_edge_weight"]
    return {
        "out_of_range": counted["out_of_range"],
        "overload": int(counted["block_weights"].max()) - cap,
        "cut_gap": gap,
        "cut": cut,
        "cut_frac": None if cut is None or total == 0 else cut / total,
    }
