"""Sequential multilevel 2-way bipartitioner + adaptive pool.

Analog of kaminpar-shm/initial_partitioning/:
  * InitialMultilevelBipartitioner (initial_multilevel_bipartitioner.cc:
    55 initialize, 83 partition): sequential LP coarsening, flat
    bipartitioner pool on the coarsest level, 2-way FM at every level of
    the uncoarsening.
  * InitialPoolBipartitioner (initial_pool_bipartitioner.h:24-56): runs
    repetitions of the enabled flat bipartitioners, keeps the best result,
    and adaptively disables bipartitioners whose running score is worst
    (use_adaptive_bipartitioner_selection).

Own copy of the JAX package's bipartitioner (kaminpar_tpu/initial/): the
native C++ engine (native/ip.cpp) runs by default, and the numpy path
below is its behavioral spec and the path under KAMINPAR_TPU_NO_NATIVE_IP=1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import native
from ..context import InitialPartitioningContext, InitialPoolContext
from ..graphs.host import HostGraph
from ..resilience.policy import with_fallback
from .coarsening import coarsen_for_bipartition
from .flat import bfs_bipartition, ggg_bipartition, random_bipartition
from .fm import fm_bipartition_refine


def _host_cut(graph: HostGraph, partition: np.ndarray) -> int:
    src = graph.edge_sources()
    ew = graph.edge_weight_array()
    return int(ew[partition[src] != partition[graph.adjncy]].sum()) // 2


def _host_block_weights(graph: HostGraph, partition: np.ndarray) -> np.ndarray:
    bw = np.zeros(2, dtype=np.int64)
    np.add.at(bw, partition, graph.node_weight_array())
    return bw


@dataclass
class _PoolEntry:
    name: str
    fn: Callable
    runs: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def record(self, cut: int) -> None:
        self.runs += 1
        delta = cut - self.mean
        self.mean += delta / self.runs
        self.m2 += delta * (cut - self.mean)

    def score(self) -> float:
        return self.mean


class PoolBipartitioner:
    """Adaptive pool over the flat bipartitioners
    (initial_pool_bipartitioner.h:24-56)."""

    def __init__(self, ctx: InitialPoolContext):
        self.ctx = ctx
        self.entries: List[_PoolEntry] = []
        if ctx.enable_bfs_bipartitioner:
            self.entries.append(_PoolEntry("bfs", bfs_bipartition))
        if ctx.enable_ggg_bipartitioner:
            self.entries.append(_PoolEntry("ggg", ggg_bipartition))
        if ctx.enable_random_bipartitioner:
            self.entries.append(_PoolEntry("random", random_bipartition))
        if not self.entries:
            self.entries.append(_PoolEntry("random", random_bipartition))

    def bipartition(
        self,
        graph: HostGraph,
        max_block_weights: np.ndarray,
        rng: np.random.Generator,
    ) -> np.ndarray:
        ctx = self.ctx
        n_reps = int(
            np.clip(
                round(ctx.repetition_multiplier * ctx.min_num_repetitions),
                1,
                ctx.max_num_repetitions,
            )
        )
        best_part: Optional[np.ndarray] = None
        best_key: Tuple[int, int] = (1 << 62, 1 << 62)
        for rep in range(n_reps):
            active = self.entries
            if (
                ctx.use_adaptive_bipartitioner_selection
                and rep >= ctx.min_num_non_adaptive_repetitions
                and len(self.entries) > 1
            ):
                # keep all but the worst-scoring bipartitioner
                ranked = sorted(self.entries, key=lambda e: e.score())
                active = ranked[:-1]
            for entry in active:
                part = entry.fn(graph, max_block_weights, rng)
                if not ctx.refinement.disabled:
                    fm_bipartition_refine(
                        graph, part, max_block_weights, ctx.refinement, rng
                    )
                cut = _host_cut(graph, part)
                bw = _host_block_weights(graph, part)
                overload = int(
                    np.maximum(bw - np.asarray(max_block_weights), 0).sum()
                )
                entry.record(cut + overload * 1000)
                key = (overload, cut)
                if key < best_key:
                    best_key = key
                    best_part = part.copy()
        assert best_part is not None
        return best_part


class InitialMultilevelBipartitioner:
    """Sequential multilevel bipartitioner
    (initial_multilevel_bipartitioner.cc)."""

    def __init__(self, ctx: InitialPartitioningContext):
        self.ctx = ctx
        self.pool = PoolBipartitioner(ctx.pool)

    def bipartition(
        self,
        graph: HostGraph,
        max_block_weights: np.ndarray,
        rng: np.random.Generator,
    ) -> np.ndarray:
        """Coarsen -> flat pool bipartition -> uncoarsen with FM refinement.
        Returns int8 partition of `graph`.

        Runs the native bipartitioner unless it is switched off or there
        is no g++ (native.enabled); the choice is made BEFORE the seed is
        drawn, so the numpy path sees the same rng stream either way.  The
        native call is the `native-ip` fault site: an injected fault (or
        its open breaker) takes the numpy path below, after the seed was
        drawn, as in the JAX package; a real build failure raises."""
        if graph.n == 0:
            return np.zeros(0, dtype=np.int8)
        max_block_weights = np.asarray(max_block_weights, dtype=np.int64)
        if native.enabled():
            seed = int(rng.integers(0, 2**62))
            part = with_fallback(
                lambda: native.ml_bipartition(
                    graph, max_block_weights, self.ctx, seed=seed),
                lambda exc: None, site="native-ip",
            )
            if part is not None:
                return part
        levels = coarsen_for_bipartition(
            graph,
            self.ctx.coarsening,
            rng,
            max_block_weight=int(max_block_weights.max()),
        )
        coarsest = levels[-1].graph if levels else graph
        part = self.pool.bipartition(coarsest, max_block_weights, rng)

        for i in range(len(levels) - 1, -1, -1):
            part = part[levels[i].cmap]  # project up
            fine_graph = levels[i - 1].graph if i > 0 else graph
            if not self.ctx.refinement.disabled:
                fm_bipartition_refine(
                    fine_graph, part, max_block_weights,
                    self.ctx.refinement, rng,
                )
        return part.astype(np.int8)


def bipartition(
    graph: HostGraph,
    max_block_weights: np.ndarray,
    ctx: InitialPartitioningContext,
    rng: np.random.Generator,
) -> np.ndarray:
    """Convenience entry point (InitialBipartitionerWorkerPool analog)."""
    return InitialMultilevelBipartitioner(ctx).bipartition(
        graph, max_block_weights, rng
    )
