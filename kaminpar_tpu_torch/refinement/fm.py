"""k-way FM refinement on the host (counterpart of
kaminpar_tpu/refinement/fm.py; fm_refiner.cc:48-110).

FM's priority-queue-driven, one-node-at-a-time control flow has no
efficient mapping onto the card (Jet is its bulk-synchronous replacement
and runs there, ops/jet.py), so FM runs on the host, as in the JAX
package: the level's graph and partition are read back, refined, and the
refined partition is uploaded.  That round trip is the only traffic.

The default is the native localized batch FM (native/fm.cpp); a build
that fails raises.  KAMINPAR_TPU_NO_NATIVE_FM=1 selects the numpy FM
below, a sequential FM with a global gain priority queue over border
nodes, best-prefix rollback and the simple stopping rule, on the gain
caches of refinement/gains.py.  A refusal of the native FM (k above its
sparse engine's limit with the dense table unaffordable) returns the
partition unchanged, as the JAX package does.  The native call is the
`native-fm` fault site: an injected fault runs the numpy FM with a
`degraded` event.
"""

from __future__ import annotations

import heapq
import os

import numpy as np
import torch

from .. import native
from ..context import FMRefinementContext
from ..graphs.csr import DeviceGraph, host_graph_from_device
from ..resilience.errors import RefinerRefused
from ..resilience.policy import with_fallback
from .gains import create_host_gain_cache


def fm_refine_host(
    dgraph: DeviceGraph,
    partition: torch.Tensor,
    k: int,
    max_block_weights: torch.Tensor,
    ctx: FMRefinementContext,
    seed: int = 0,
    threads: int = 1,
) -> torch.Tensor:
    """Refine a device partition with host FM; returns a device partition
    of the same padded length.  `threads` > 1 runs the native FM's worker
    pool, whose result depends on the threads' timing."""
    graph = host_graph_from_device(dgraph)
    n = graph.n
    part = partition[:n].cpu().numpy().astype(np.int32)
    max_bw = max_block_weights[:k].cpu().numpy().astype(np.int64)

    def _numpy_fm() -> np.ndarray:
        node_w = graph.node_weight_array()
        edge_w = graph.edge_weight_array()
        rng = np.random.default_rng(seed)
        for _ in range(max(1, ctx.num_iterations)):
            improvement, _, _ = _fm_pass(
                graph, part, node_w, edge_w, max_bw, k, ctx, rng
            )
            if improvement <= 0:
                break
        return part

    if os.environ.get(native.NO_NATIVE_FM_ENV, "") == "1":
        _numpy_fm()
    else:
        def _native_fm() -> np.ndarray:
            # refines `part` in place; a refusal returns before fm.cpp
            # writes to it and surfaces as a structured RefinerRefused
            if native.fm_refine(graph, part, k, max_bw, ctx, seed,
                                threads=threads) == native.FM_REFUSED:
                raise RefinerRefused(
                    f"native FM refused to run at n={graph.n}, k={k}")
            return part

        def _fm_fallback(exc) -> np.ndarray:
            # a real refusal keeps the partition; an injected fault (or an
            # open breaker) runs the numpy FM
            if isinstance(exc, RefinerRefused) and not exc.injected:
                return part
            return _numpy_fm()

        with_fallback(_native_fm, _fm_fallback, site="native-fm")

    padded = torch.zeros(dgraph.n_pad, dtype=torch.int32)
    padded[:n] = torch.from_numpy(part)
    return padded.to(dgraph.device)


def _fm_pass(graph, part, node_w, edge_w, max_bw, k, ctx, rng):
    """One FM pass; returns (committed gain, attempted moves, kept
    best-prefix length) — the per-pass progress triple."""
    n = graph.n
    src = graph.edge_sources()
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, part, node_w)

    # border nodes: incident to a cut edge
    cut_edge = part[src] != part[graph.adjncy]
    border = np.unique(src[cut_edge])
    if len(border) == 0:
        return 0, 0, 0

    cache = create_host_gain_cache(graph, part, k)
    pq = []
    tie = rng.random(n)
    in_pq = np.zeros(n, dtype=bool)
    for u in border:
        mv = cache.best_move(int(u), part, node_w, bw, max_bw)
        if mv is not None:
            heapq.heappush(pq, (-mv[0], tie[u], int(u), mv[1]))
            in_pq[u] = True

    locked = np.zeros(n, dtype=bool)
    moves = []
    cur_delta = 0
    best_delta = 0
    best_len = 0
    fruitless = 0

    while pq:
        negg, _, u, t = heapq.heappop(pq)
        if locked[u]:
            continue
        # gains may be stale: re-query the cache and re-push if changed
        mv = cache.best_move(u, part, node_w, bw, max_bw)
        if mv is None:
            continue
        gain, t = mv
        if -negg != gain:
            heapq.heappush(pq, (-gain, tie[u], u, t))
            continue
        if bw[t] + node_w[u] > max_bw[t]:
            continue

        b = int(part[u])
        part[u] = t
        bw[b] -= node_w[u]
        bw[t] += node_w[u]
        cache.apply_move(u, b, t)
        locked[u] = True
        cur_delta += gain
        moves.append((u, b))
        if cur_delta > best_delta:
            best_delta = cur_delta
            best_len = len(moves)
            fruitless = 0
        else:
            fruitless += 1
            if fruitless >= ctx.num_fruitless_moves:
                break

        # re-queue unlocked neighbors (their cached rows just changed)
        lo, hi = int(graph.xadj[u]), int(graph.xadj[u + 1])
        for v in graph.adjncy[lo:hi]:
            v = int(v)
            if not locked[v]:
                mv = cache.best_move(v, part, node_w, bw, max_bw)
                if mv is not None:
                    heapq.heappush(pq, (-mv[0], tie[v], v, mv[1]))

    # rollback to best prefix
    for u, b in moves[best_len:]:
        t = int(part[u])
        part[u] = b
        bw[t] -= node_w[u]
        bw[b] += node_w[u]
    return best_delta, len(moves), best_len
