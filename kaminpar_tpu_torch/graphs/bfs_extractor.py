"""BFS region extraction — the BfsExtractor analog (own copy of
kaminpar_tpu/graphs/bfs_extractor.py).

The reference extracts the `max_hops`-hop BFS region around seed nodes as
a standalone shared-memory graph so a local algorithm (e.g. localized FM)
can run on it, with the *exterior* of the region collapsed into one
pseudo-node per block so the region still feels its attachment to the
rest of the partition (kaminpar-dist/graphutils/bfs_extractor.h:28-46,
bfs_extractor.cc).

Split of labor: hop distances come from the device op
(ops/bfs.bfs_hops — one segment_min per hop); the region graph itself is
assembled host-side with numpy (region graphs are small by construction —
that is their purpose — so assembly is off the hot path, like the
reference building an shm graph out of the BFS result).

Layout of the extracted graph: region nodes first (in ascending original
id), then k pseudo-nodes (one per block, weight = the block's total
weight outside the region).  Every edge from a region node to an
exterior node is redirected to the exterior node's block pseudo-node,
parallel edges merged by weight sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .host import HostGraph, from_edge_list


@dataclass
class BfsExtraction:
    """Result of extract_bfs_subgraph.

    graph        : the region graph (region nodes + k block pseudo-nodes)
    node_mapping : i64[region_size] original node id of each region node
    partition    : i32[graph.n] block of each extracted node (pseudo-node
                   i carries block i)
    num_region   : number of real region nodes (graph.n - k)
    """

    graph: HostGraph
    node_mapping: np.ndarray
    partition: np.ndarray
    num_region: int

    def project_back(self, region_partition: np.ndarray, partition: np.ndarray) -> np.ndarray:
        """Write the region nodes' (possibly changed) blocks back into the
        full partition vector (pseudo-nodes are dropped — they never move).
        Returns the updated full partition."""
        out = partition.copy()
        out[self.node_mapping] = region_partition[: self.num_region]
        return out


def extract_bfs_subgraph(
    host: HostGraph,
    partition: np.ndarray,
    seeds: np.ndarray,
    max_hops: int,
    k: int,
    hops: np.ndarray | None = None,
) -> BfsExtraction:
    """Extract the BFS region around `seeds` with contracted exterior.

    `hops` may be supplied (e.g. ops.bfs.bfs_hops(...)[:n].cpu().numpy()) to
    reuse a device BFS; otherwise a host BFS is run.  Mirrors
    BfsExtractor::extract (bfs_extractor.cc) with the CONTRACT exterior
    strategy: one pseudo-node per block absorbs all exterior nodes.
    """
    n = host.n
    partition = np.asarray(partition, dtype=np.int32)[:n]
    if hops is None:
        hops = _host_bfs(host, np.asarray(seeds, dtype=np.int64), max_hops)
    else:
        hops = np.asarray(hops, dtype=np.int64)[:n]

    in_region = hops <= max_hops
    region = np.flatnonzero(in_region)
    num_region = len(region)
    # new id: region nodes by ascending original id, then pseudo-nodes
    new_id = np.full(n, -1, dtype=np.int64)
    new_id[region] = np.arange(num_region)

    src = host.edge_sources()
    dst = host.adjncy
    ew = host.edge_weight_array()
    from_region = in_region[src]
    to_region = in_region[dst]

    # interior edges keep both endpoints; boundary edges are redirected to
    # the exterior endpoint's block pseudo-node (id num_region + block)
    keep = from_region
    s0 = new_id[src[keep]]
    d_orig = dst[keep]
    boundary = ~to_region[keep]
    d0 = np.where(
        ~boundary,
        new_id[d_orig],
        num_region + partition[d_orig].astype(np.int64),
    )
    w0 = ew[keep]
    # interior edges already exist in both directions in the CSR; only the
    # redirected boundary edges need their reverse (pseudo -> region) added
    s = np.concatenate([s0, d0[boundary]])
    d = np.concatenate([d0, s0[boundary]])
    w = np.concatenate([w0, w0[boundary]])

    node_weights = np.zeros(num_region + k, dtype=np.int64)
    node_weights[:num_region] = host.node_weight_array()[region]
    # pseudo-node weight = block weight outside the region, so block-weight
    # constraints seen by a local refiner match the global ones
    ext_bw = np.bincount(
        partition[~in_region],
        weights=host.node_weight_array()[~in_region],
        minlength=k,
    ).astype(np.int64)
    node_weights[num_region:] = ext_bw

    edges = np.stack([s, d], axis=1)
    graph = from_edge_list(
        num_region + k,
        edges,
        edge_weights=w,
        node_weights=node_weights,
        symmetrize=False,  # both directions are materialized above
    )
    part_out = np.empty(num_region + k, dtype=np.int32)
    part_out[:num_region] = partition[region]
    part_out[num_region:] = np.arange(k, dtype=np.int32)
    return BfsExtraction(
        graph=graph,
        node_mapping=region,
        partition=part_out,
        num_region=num_region,
    )


def _host_bfs(host: HostGraph, seeds: np.ndarray, max_hops: int) -> np.ndarray:
    """Simple host-side BFS fallback (same semantics as ops/bfs.bfs_hops)."""
    n = host.n
    INF = np.iinfo(np.int64).max
    dist = np.full(n, INF, dtype=np.int64)
    seeds = seeds[(seeds >= 0) & (seeds < n)]
    dist[seeds] = 0
    frontier = seeds
    for h in range(max_hops):
        nxt = []
        for u in frontier:
            for v in host.neighbors(u):
                if dist[v] == INF:
                    dist[v] = h + 1
                    nxt.append(v)
        if not nxt:
            break
        frontier = np.asarray(nxt, dtype=np.int64)
    return dist
