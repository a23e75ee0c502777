"""Host-side (numpy) CSR graph.

TPU-native analog of kaminpar-shm/datastructures/csr_graph.h:35 — the
`nodes[n+1] / edges[m] / node_weights / edge_weights` StaticArray quartet —
kept as numpy arrays on the host.  The host graph is the ingestion / IO /
initial-partitioning representation; `graphs.csr.DeviceGraph` is its padded
device twin.  Own copy of the JAX package's numpy module.

Also hosts the graph utilities that the reference keeps in
kaminpar-shm/graphutils/: permutation (permutator.h),
validation (graph_validator.cc), and block-induced subgraph extraction
(subgraph_extractor.h:36).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

NODE_DTYPE = np.int32
WEIGHT_DTYPE = np.int64


@dataclass
class HostGraph:
    """CSR graph on the host. Undirected graphs store each edge twice
    (METIS convention), exactly like the reference's CSRGraph."""

    xadj: np.ndarray  # int (n+1,) row pointers
    adjncy: np.ndarray  # int32 (m,) neighbor ids
    node_weights: Optional[np.ndarray] = None  # int (n,) or None => unit
    edge_weights: Optional[np.ndarray] = None  # int (m,) or None => unit

    def __post_init__(self) -> None:
        self.xadj = np.asarray(self.xadj, dtype=np.int64)
        self.adjncy = np.asarray(self.adjncy, dtype=NODE_DTYPE)
        if self.node_weights is not None:
            self.node_weights = np.asarray(self.node_weights, dtype=WEIGHT_DTYPE)
        if self.edge_weights is not None:
            self.edge_weights = np.asarray(self.edge_weights, dtype=WEIGHT_DTYPE)

    # -- basic properties (CSRGraph interface surface, csr_graph.h) --
    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def m(self) -> int:
        return len(self.adjncy)

    def is_node_weighted(self) -> bool:
        return self.node_weights is not None

    def is_edge_weighted(self) -> bool:
        return self.edge_weights is not None

    def node_weight_array(self) -> np.ndarray:
        if self.node_weights is None:
            return np.ones(self.n, dtype=WEIGHT_DTYPE)
        return self.node_weights

    def edge_weight_array(self) -> np.ndarray:
        if self.edge_weights is None:
            return np.ones(self.m, dtype=WEIGHT_DTYPE)
        return self.edge_weights

    @property
    def total_node_weight(self) -> int:
        return self.n if self.node_weights is None else int(self.node_weights.sum())

    @property
    def total_edge_weight(self) -> int:
        return self.m if self.edge_weights is None else int(self.edge_weights.sum())

    def degrees(self) -> np.ndarray:
        return (self.xadj[1:] - self.xadj[:-1]).astype(np.int64)

    def max_degree(self) -> int:
        return 0 if self.n == 0 else int(self.degrees().max())

    def neighbors(self, u: int) -> np.ndarray:
        return self.adjncy[self.xadj[u] : self.xadj[u + 1]]

    def edge_sources(self) -> np.ndarray:
        """COO source per directed edge (repeat-interleave of node ids)."""
        return np.repeat(
            np.arange(self.n, dtype=NODE_DTYPE), self.degrees()
        )


def from_edge_list(
    n: int,
    edges: np.ndarray,
    edge_weights: Optional[np.ndarray] = None,
    node_weights: Optional[np.ndarray] = None,
    symmetrize: bool = True,
) -> HostGraph:
    """Build a CSR HostGraph from an (e, 2) array of undirected edges.

    Each undirected edge is materialized in both directions (METIS/CSRGraph
    convention).  Parallel edges are merged by weight sum; self-loops dropped.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edge_weights is None:
        edge_weights = np.ones(len(edges), dtype=WEIGHT_DTYPE)
    edge_weights = np.asarray(edge_weights, dtype=WEIGHT_DTYPE)

    if symmetrize:
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        w = np.concatenate([edge_weights, edge_weights])
    else:
        src, dst, w = edges[:, 0], edges[:, 1], edge_weights

    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]

    # merge duplicates
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    if len(key):
        uniq_mask = np.empty(len(key), dtype=bool)
        uniq_mask[0] = True
        uniq_mask[1:] = key[1:] != key[:-1]
        seg = np.cumsum(uniq_mask) - 1
        w = np.bincount(seg, weights=w, minlength=seg[-1] + 1 if len(seg) else 0).astype(
            WEIGHT_DTYPE
        )
        src, dst = src[uniq_mask], dst[uniq_mask]

    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    xadj = np.cumsum(xadj)
    unit_w = bool(len(w) == 0 or (w == 1).all())
    return HostGraph(
        xadj=xadj,
        adjncy=dst.astype(NODE_DTYPE),
        node_weights=node_weights,
        edge_weights=None if unit_w else w,
    )


# ---------------------------------------------------------------------------
# Validation (analog of kaminpar-shm/graphutils/graph_validator.cc)
# ---------------------------------------------------------------------------


def from_csr(
    xadj, adjncy, node_weights=None, edge_weights=None
) -> HostGraph:
    return HostGraph(xadj, adjncy, node_weights, edge_weights)


def validate(graph: HostGraph, undirected: bool = True) -> None:
    """Raise ValueError on malformed CSR; checks the same invariants as the
    reference validator: monotone xadj, in-range neighbors, no self-loops,
    and (optionally) symmetry with matching edge weights."""
    n, m = graph.n, graph.m
    if graph.xadj[0] != 0 or graph.xadj[-1] != m:
        raise ValueError("xadj must start at 0 and end at m")
    if (np.diff(graph.xadj) < 0).any():
        raise ValueError("xadj must be non-decreasing")
    if m and (graph.adjncy.min() < 0 or graph.adjncy.max() >= n):
        raise ValueError("neighbor id out of range")
    src = graph.edge_sources()
    if (src == graph.adjncy).any():
        raise ValueError("self loops are not allowed")
    if undirected and m:
        w = graph.edge_weight_array()
        fwd = np.lexsort((graph.adjncy, src))
        rev = np.lexsort((src, graph.adjncy))
        if not (
            np.array_equal(src[fwd], graph.adjncy[rev])
            and np.array_equal(graph.adjncy[fwd], src[rev])
            and np.array_equal(w[fwd], w[rev])
        ):
            raise ValueError("graph is not symmetric (or edge weights differ)")


# ---------------------------------------------------------------------------
# Permutation (analog of graphutils/permutator.{h,cc})
# ---------------------------------------------------------------------------


@dataclass
class NodePermutation:
    old_to_new: np.ndarray
    new_to_old: np.ndarray


def degree_bucket_permutation(graph: HostGraph) -> NodePermutation:
    """Stable sort of nodes into exponentially-spaced degree buckets
    (permutator.h:233 rearrange_by_degree_buckets): a node's bucket is
    floor(log2(degree)) + 1, bucket 0 holds the isolated nodes."""
    deg = graph.degrees()
    bucket = np.zeros(graph.n, dtype=np.int64)
    nz = deg > 0
    bucket[nz] = np.floor(np.log2(deg[nz])).astype(np.int64) + 1
    new_to_old = np.argsort(bucket, kind="stable").astype(NODE_DTYPE)
    old_to_new = np.empty_like(new_to_old)
    old_to_new[new_to_old] = np.arange(graph.n, dtype=NODE_DTYPE)
    return NodePermutation(old_to_new=old_to_new, new_to_old=new_to_old)


def apply_permutation(graph: HostGraph, perm: NodePermutation) -> HostGraph:
    """Rebuild the CSR with nodes renumbered by perm.old_to_new."""
    deg = graph.degrees()
    new_deg = deg[perm.new_to_old]
    new_xadj = np.zeros(graph.n + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_xadj[1:])
    new_ew = None if graph.edge_weights is None else np.empty_like(graph.edge_weights)
    # vectorized edge copy: for each new node u, its edge range maps to the
    # old node's range
    old_starts = graph.xadj[perm.new_to_old]
    idx = np.repeat(old_starts, new_deg) + (
        np.arange(graph.m) - np.repeat(new_xadj[:-1], new_deg)
    )
    new_adjncy = perm.old_to_new[graph.adjncy[idx]]
    if new_ew is not None:
        new_ew = graph.edge_weights[idx]
    nw = None
    if graph.node_weights is not None:
        nw = graph.node_weights[perm.new_to_old]
    return HostGraph(new_xadj, new_adjncy.astype(NODE_DTYPE), nw, new_ew)


def count_isolated_nodes(graph: HostGraph) -> int:
    return int((graph.degrees() == 0).sum())


def remove_isolated_nodes(
    graph: HostGraph,
) -> Tuple[HostGraph, NodePermutation, int]:
    """Push isolated nodes to the back and return the subgraph without them
    (kaminpar.cc:392-404).  Returns (core graph, permutation over the FULL
    node set, num_isolated)."""
    deg = graph.degrees()
    isolated = deg == 0
    num_isolated = int(isolated.sum())
    new_to_old = np.concatenate(
        [np.flatnonzero(~isolated), np.flatnonzero(isolated)]
    ).astype(NODE_DTYPE)
    old_to_new = np.empty_like(new_to_old)
    old_to_new[new_to_old] = np.arange(graph.n, dtype=NODE_DTYPE)
    perm = NodePermutation(old_to_new=old_to_new, new_to_old=new_to_old)
    permuted = apply_permutation(graph, perm)
    core_n = graph.n - num_isolated
    core = HostGraph(
        xadj=permuted.xadj[: core_n + 1],
        adjncy=permuted.adjncy,
        node_weights=None
        if permuted.node_weights is None
        else permuted.node_weights[:core_n],
        edge_weights=permuted.edge_weights,
    )
    return core, perm, num_isolated


# ---------------------------------------------------------------------------
# Subgraph extraction (analog of graphutils/subgraph_extractor.{h,cc})
# ---------------------------------------------------------------------------


@dataclass
class SubgraphExtraction:
    subgraphs: list  # list[HostGraph], one per block
    node_mapping: np.ndarray  # (n,) position of node inside its block subgraph


def extract_block_subgraphs(
    graph: HostGraph, partition: np.ndarray, k: int
) -> SubgraphExtraction:
    """Extract the k block-induced subgraphs (subgraph_extractor.h:103-177).
    Edges crossing blocks are dropped; node ids are renumbered per block."""
    partition = np.asarray(partition)
    order = np.argsort(partition, kind="stable").astype(NODE_DTYPE)
    # position of each node within its block
    block_sizes = np.bincount(partition, minlength=k)
    block_starts = np.concatenate([[0], np.cumsum(block_sizes)])
    pos_in_block = np.empty(graph.n, dtype=NODE_DTYPE)
    pos_in_block[order] = (
        np.arange(graph.n, dtype=NODE_DTYPE) - block_starts[partition[order]]
    ).astype(NODE_DTYPE)

    src = graph.edge_sources()
    ew = graph.edge_weight_array()
    nw = graph.node_weight_array()

    subgraphs = []
    for b in range(k):
        nodes_b = order[block_starts[b] : block_starts[b + 1]]
        edge_mask = (partition[src] == b) & (partition[graph.adjncy] == b)
        s = pos_in_block[src[edge_mask]]
        d = pos_in_block[graph.adjncy[edge_mask]]
        w = ew[edge_mask]
        nb = len(nodes_b)
        xadj = np.zeros(nb + 1, dtype=np.int64)
        np.add.at(xadj, s + 1, 1)
        xadj = np.cumsum(xadj)
        o = np.lexsort((d, s))
        sub = HostGraph(
            xadj=xadj,
            adjncy=d[o].astype(NODE_DTYPE),
            node_weights=nw[nodes_b] if graph.node_weights is not None else None,
            edge_weights=w[o] if graph.edge_weights is not None else None,
        )
        subgraphs.append(sub)
    return SubgraphExtraction(subgraphs=subgraphs, node_mapping=pos_in_block)


def host_partition_metrics(graph: HostGraph, partition, k: int) -> dict:
    """Cut / block weights / imbalance / feasibility on the host (the
    numpy twin of ops/metrics; shared by the RESULT printer and the
    partition-properties tool so the definitions cannot drift)."""
    partition = np.asarray(partition)
    src = graph.edge_sources()
    ew = graph.edge_weight_array()
    cut = int(ew[partition[src] != partition[graph.adjncy]].sum() // 2)
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, partition, graph.node_weight_array())
    perfect = max(1, -(-graph.total_node_weight // max(k, 1)))
    return {
        "cut": cut,
        "block_weights": bw,
        "imbalance": bw.max() / perfect - 1.0 if k else 0.0,
    }
