"""Gain caches (counterpart of kaminpar_tpu/refinement/gains.py, mirroring
kaminpar-shm/refinement/gains/).

A gain cache keeps per-(node, block) connection weights so that a refiner
reads a move's gain, gain(u, from, to) = conn(u, to) - conn(u, from),
without walking u's edges, and updates them as nodes move.

Device strategies, as plain torch ops on the graph's device:
  * build_dense_gain_cache / update_dense_gain_cache /
    best_moves_from_cache: a dense i32[n_pad, k] connection matrix, built
    with one segment sum and updated after a bulk move round with two
    scatter-adds over the edges whose target moved;
  * on_the_fly_gains: no table, the aggregate_by_key triple the LP and
    Jet rounds consume.

Host strategies, in numpy, for the numpy FM (refinement/fm.py):
  * HostDenseGainCache: an (n, k) matrix with incremental move updates;
  * HostOnTheFlyGainCache: recomputes from the adjacency, O(deg + k);
  * HostDeltaGainCache: a speculative overlay over a dense cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..dtypes import ACC_DTYPE, INT32_MIN
from ..graphs.csr import DeviceGraph
from ..ops.segments import aggregate_by_key, segment_sum


# ---------------------------------------------------------------------------
# Device dense gain cache (SparseGainCache analog)
# ---------------------------------------------------------------------------


def _flat_index(graph: DeviceGraph, block: torch.Tensor, k: int):
    return graph.src.to(torch.int64) * k + block[graph.dst.to(torch.int64)]


def build_dense_gain_cache(
    graph: DeviceGraph, partition: torch.Tensor, k: int
) -> torch.Tensor:
    """conn[u, b] = total weight of u's edges into block b (one segment
    sum over the COO edge list)."""
    n_pad = graph.n_pad
    if n_pad * k >= 2**31:
        raise ValueError("n_pad * k must fit in int32")
    part_c = partition.clamp(0, k - 1)
    conn = segment_sum(
        graph.edge_w.to(ACC_DTYPE), _flat_index(graph, part_c, k),
        n_pad * k,
    )
    return conn.view(n_pad, k)


def update_dense_gain_cache(
    conn: torch.Tensor,
    graph: DeviceGraph,
    old_partition: torch.Tensor,
    new_partition: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """The cache after a bulk move round: for every edge (u, v) whose
    target v moved a -> b, conn[u, a] -= w(uv) and conn[u, b] += w(uv)
    (wrapping int32).  Returns a new tensor; `conn` is left as it is."""
    old_c = old_partition.clamp(0, k - 1)
    new_c = new_partition.clamp(0, k - 1)
    dst = graph.dst.to(torch.int64)
    moved = old_c[dst] != new_c[dst]
    w = torch.where(moved, graph.edge_w, 0).to(ACC_DTYPE)
    flat = conn.reshape(-1).clone()
    flat.index_add_(0, _flat_index(graph, old_c, k), -w)
    flat.index_add_(0, _flat_index(graph, new_c, k), w)
    return flat.view(conn.shape)


def best_moves_from_cache(
    conn: torch.Tensor,
    partition: torch.Tensor,
    node_w: torch.Tensor,
    block_weights: torch.Tensor,
    max_block_weights: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node (best_target, gain) from a dense cache under the block
    weight caps, ties to the lowest block; rows with no feasible target
    return -1 / INT32_MIN."""
    part_c = partition.clamp(0, k - 1).to(torch.int64)
    own = conn.gather(1, part_c[:, None])[:, 0]
    cap = max_block_weights.to(ACC_DTYPE).expand(k)
    fits = (
        block_weights[None, :].to(ACC_DTYPE)
        + node_w[:, None].to(ACC_DTYPE)
        <= cap[None, :]
    )
    blocks = torch.arange(k, device=conn.device)
    is_own = blocks[None, :] == part_c[:, None]
    score = torch.where(fits & ~is_own, conn, INT32_MIN)
    best = score.argmax(dim=1)  # the first index of a tied maximum
    best_w = score.gather(1, best[:, None])[:, 0]
    has = best_w > INT32_MIN
    gain = torch.where(has, best_w - own, INT32_MIN)
    return torch.where(has, best, -1).to(torch.int32), gain


def on_the_fly_gains(
    graph: DeviceGraph, partition: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OnTheFlyGainCache strategy (on_the_fly_gain_cache.h:25): no
    materialized table -- the aggregate_by_key triple (seg_g, key_g, w_g)
    listing each node's adjacent blocks with their connection weights."""
    part_c = partition.clamp(0, k - 1)
    return aggregate_by_key(
        graph.src, part_c[graph.dst.to(torch.int64)], graph.edge_w
    )


# ---------------------------------------------------------------------------
# Host caches (FM support)
# ---------------------------------------------------------------------------


class HostDenseGainCache:
    """Dense (n, k) connection matrix on host with incremental move
    updates — the host FM's gain authority (DenseGainCache analog).

    Invariant (gain_cache_test.cc's validation property): after any move
    sequence applied through `apply_move`, `self.conn` equals a fresh
    rebuild from the current partition."""

    def __init__(self, host_graph, partition: np.ndarray, k: int):
        self.g = host_graph
        self.k = k
        n = host_graph.n
        self.src = host_graph.edge_sources()
        self.dst = host_graph.adjncy
        self.ew = host_graph.edge_weight_array()
        # int32 matches the device ACC_DTYPE; entries are bounded by a
        # node's weighted degree
        self.conn = np.zeros((n, k), dtype=np.int32)
        np.add.at(
            self.conn,
            (self.src, np.asarray(partition, np.int64)[self.dst]),
            self.ew,
        )

    def gain(self, u: int, b_from: int, b_to: int) -> int:
        return int(self.conn[u, b_to] - self.conn[u, b_from])

    def best_move(
        self,
        u: int,
        part: np.ndarray,
        node_w: np.ndarray,
        bw: np.ndarray,
        max_bw: np.ndarray,
    ) -> Optional[Tuple[int, int]]:
        """Best feasible (gain, target) for u, O(k)."""
        b = int(part[u])
        row = self.conn[u]
        feas = bw + node_w[u] <= max_bw
        feas[b] = False
        if not feas.any():
            return None
        masked = np.where(feas, row, -(1 << 62))
        t = int(np.argmax(masked))
        if masked[t] <= -(1 << 62):
            return None
        return int(row[t] - row[b]), t

    def apply_move(self, u: int, b_from: int, b_to: int) -> None:
        """Move u and update the neighbors' rows (move(), O(deg(u)))."""
        lo, hi = int(self.g.xadj[u]), int(self.g.xadj[u + 1])
        neigh = self.dst[lo:hi]
        w = self.ew[lo:hi]
        np.subtract.at(self.conn, (neigh, b_from), w)
        np.add.at(self.conn, (neigh, b_to), w)


class HostOnTheFlyGainCache:
    """On-the-fly strategy for host FM (on_the_fly_gain_cache.h:25): no
    table — best_move recomputes from the adjacency in O(deg + k).  Used
    when the dense (n, k) table would not fit comfortably in memory."""

    def __init__(self, host_graph, partition: np.ndarray, k: int):
        self.g = host_graph
        self.k = k
        self.dst = host_graph.adjncy
        self.ew = host_graph.edge_weight_array()
        self.part = partition  # shared, caller mutates it before apply_move

    def best_move(self, u, part, node_w, bw, max_bw):
        lo, hi = int(self.g.xadj[u]), int(self.g.xadj[u + 1])
        if lo == hi:
            return None
        conn = np.zeros(self.k, dtype=np.int64)
        np.add.at(conn, part[self.dst[lo:hi]], self.ew[lo:hi])
        b = int(part[u])
        own = conn[b]
        feas = bw + node_w[u] <= max_bw
        feas[b] = False
        masked = np.where(feas, conn, -(1 << 62))
        t = int(np.argmax(masked))
        if masked[t] <= -(1 << 62):
            return None
        return int(conn[t] - own), t

    def apply_move(self, u: int, b_from: int, b_to: int) -> None:
        pass  # nothing cached


# dense table above this many entries falls back to on-the-fly
DENSE_CACHE_MAX_ENTRIES = 1 << 26


def create_host_gain_cache(host_graph, partition: np.ndarray, k: int):
    """Strategy picker (the factories.cc gain-cache dispatch analog):
    dense when the (n, k) table is affordable, on-the-fly otherwise."""
    if host_graph.n * k <= DENSE_CACHE_MAX_ENTRIES:
        return HostDenseGainCache(host_graph, partition, k)
    return HostOnTheFlyGainCache(host_graph, partition, k)


class HostDeltaGainCache:
    """Speculative overlay (delta_gain_caches.h:202 analog): FM batches
    try moves against the delta; `commit()` folds them into the base,
    `clear()` discards them."""

    def __init__(self, base: HostDenseGainCache):
        self.base = base
        self._delta: Dict[Tuple[int, int], int] = {}
        self._moves: list[Tuple[int, int, int]] = []

    def _conn(self, u: int, b: int) -> int:
        return int(self.base.conn[u, b]) + self._delta.get((u, b), 0)

    def gain(self, u: int, b_from: int, b_to: int) -> int:
        return self._conn(u, b_to) - self._conn(u, b_from)

    def apply_move(self, u: int, b_from: int, b_to: int) -> None:
        g = self.base.g
        lo, hi = int(g.xadj[u]), int(g.xadj[u + 1])
        for v, w in zip(self.base.dst[lo:hi], self.base.ew[lo:hi]):
            v = int(v)
            self._delta[(v, b_from)] = self._delta.get((v, b_from), 0) - int(w)
            self._delta[(v, b_to)] = self._delta.get((v, b_to), 0) + int(w)
        self._moves.append((u, b_from, b_to))

    def commit(self) -> None:
        for u, b_from, b_to in self._moves:
            self.base.apply_move(u, b_from, b_to)
        self.clear()

    def clear(self) -> None:
        self._delta.clear()
        self._moves.clear()
