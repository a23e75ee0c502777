"""Mesh-subgroup replication for distributed deep multilevel (own copy of
kaminpar_tpu/parallel/replication.py).

Analog of the reference's PE-group splitting
(kaminpar-dist/partitioning/deep_multilevel.cc:79-153 +
kaminpar-dist/graphutils/replicator.cc:26-34 replicate_graph /
distribute_best_partition): once the coarse graph is too small to keep
every PE busy, the reference splits the PEs into subgroups that coarsen
independent replicas of the graph and later keeps the best partition.

The mesh realization avoids a second mesh axis entirely: G replicas
of the n-node graph are laid out as ONE block-diagonal union graph
(replica g's node v becomes union node g*n + v).  Sharding the union
over the existing 1D node axis hands each D/G-device subgroup one
replica, and every dist kernel (LP clustering, sharded contraction,
refinement) runs on the union unchanged — components are disjoint, so
no collective ever mixes replicas, and the halo exchange carries no
cross-replica traffic.  Replicas diverge because every hashed decision
(tie-breaking, participation sampling) keys on the node id, which is
offset per replica — the id offset IS the per-replica seed.

Refinement on the union keeps replicas independent by giving replica g
the block-id range [g*k, (g+1)*k) with tiled weight caps, so balancers
and refiners enforce each replica's constraints separately.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..graphs.host import HostGraph


def choose_replication_factor(n: int, num_devices: int, min_nodes_per_device: int) -> int:
    """Smallest power-of-two G in [2, D] that restores >= min_nodes_per
    _device nodes per device (G*n/D >= threshold); 1 when the graph is
    still big enough (or D == 1)."""
    D = int(num_devices)
    if D < 2 or n <= 0 or min_nodes_per_device <= 0:
        return 1
    if n >= D * min_nodes_per_device:
        return 1
    G = 2
    while G < D and G * n < D * min_nodes_per_device:
        G *= 2
    return min(G, D)


def union_graph(graph: HostGraph, G: int) -> HostGraph:
    """Block-diagonal union of G copies of `graph` (replica g's node v
    -> union node g*n + v).  The replicate_graph analog — instead of
    sending the graph to every PE subgroup, the union's natural node
    sharding places one copy per subgroup."""
    n, m = graph.n, graph.m
    xadj = graph.xadj
    u_xadj = np.concatenate(
        [[0]] + [xadj[1:] + g * m for g in range(G)]
    ).astype(np.int64)
    u_adjncy = np.concatenate(
        [graph.adjncy.astype(np.int64) + g * n for g in range(G)]
    ).astype(np.int64 if G * n > np.iinfo(np.int32).max else np.int32)
    nw = graph.node_weights
    ew = graph.edge_weights
    return HostGraph(
        xadj=u_xadj,
        adjncy=u_adjncy,
        node_weights=None if nw is None else np.tile(np.asarray(nw), G),
        edge_weights=None if ew is None else np.tile(np.asarray(ew), G),
    )


def replica_bounds_after_contraction(
    cmap: np.ndarray, bounds: List[int]
) -> List[int]:
    """Coarse-side replica boundaries.  Coarse ids are dense ranks of
    leader node ids (ascending), and replica g's leaders all lie in
    [bounds[g], bounds[g+1]), so its coarse ids are the contiguous range
    [new_bounds[g], new_bounds[g+1])."""
    new_bounds = [0]
    for g in range(len(bounds) - 1):
        lo, hi = bounds[g], bounds[g + 1]
        new_bounds.append(
            int(cmap[lo:hi].max()) + 1 if hi > lo else new_bounds[-1]
        )
    return new_bounds


def slice_replica(graph: HostGraph, lo: int, hi: int) -> HostGraph:
    """Extract replica component [lo, hi) of a union graph (edges of a
    disjoint component never leave it)."""
    xadj = graph.xadj
    e0, e1 = int(xadj[lo]), int(xadj[hi])
    nw = graph.node_weights
    ew = graph.edge_weights
    return HostGraph(
        xadj=(xadj[lo : hi + 1] - xadj[lo]).astype(np.int64),
        adjncy=(graph.adjncy[e0:e1] - lo).astype(np.int32),
        node_weights=None if nw is None else np.asarray(nw)[lo:hi],
        edge_weights=None if ew is None else np.asarray(ew)[e0:e1],
    )


def best_replica_partition(
    split_graph: HostGraph,
    union_partition: np.ndarray,
    G: int,
    k: int,
) -> Tuple[np.ndarray, int, int]:
    """distribute_best_partition analog: evaluate each replica's
    partition of the (identical) split-level graph and return
    (partition in [0, k), winning replica, its cut).  `union_partition`
    holds replica g's blocks in the id range [g*k, (g+1)*k)."""
    n = split_graph.n
    src = split_graph.edge_sources()
    ew = split_graph.edge_weight_array()
    adj = split_graph.adjncy
    best = None
    for g in range(G):
        part_g = union_partition[g * n : (g + 1) * n] - g * k
        cut = int(ew[part_g[src] != part_g[adj]].sum() // 2)
        if best is None or cut < best[2]:
            best = (part_g, g, cut)
    return best
