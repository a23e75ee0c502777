"""Device multilevel coarsener (counterpart of
kaminpar_tpu/partitioning/coarsener.py): LP clustering then contraction,
level by level, with the reference's max-cluster-weight formula, the
forced-shrink retries, the hash-engine last resort and the limping-tail
cutoff.  Under SPARSIFICATION_CLUSTERING (linear-time MGP) a level of more
than 2^16 edges is clustered on a sparsified copy (ops/sparsify.py) and
the true graph is contracted.  The JAX package's spill, checkpoint,
integrity, telemetry and overlay hooks are not part of this package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import torch

from ..context import (
    CoarseningAlgorithm,
    Context,
    IsolatedNodesStrategy,
    TwoHopStrategy,
)
from ..dtypes import WMAX
from ..graphs.csr import DeviceGraph
from ..ops.contraction import CoarseGraph, contract_clustering
from ..ops.lp import LPConfig, lp_cluster
from ..ops.rating import select_engine
from ..ops.sparsify import sparsify_edges

# the coarsening algorithms this package runs
_ALGORITHMS = (
    CoarseningAlgorithm.BASIC_CLUSTERING,
    CoarseningAlgorithm.SPARSIFICATION_CLUSTERING,
)
# sparsification clusters levels with more edges than this
SPARSIFY_MIN_EDGES = 1 << 16


@dataclass
class CoarseningLevel:
    """One hierarchy step."""

    fine_graph: DeviceGraph
    coarse: CoarseGraph
    fine_n: int
    coarse_n: int
    coarse_m: int


class Coarsener:
    """Cluster coarsener with hierarchy (coarsener.h:20-88 interface)."""

    def __init__(self, ctx: Context, graph: DeviceGraph, n: int):
        if ctx.coarsening.algorithm not in _ALGORITHMS:
            raise NotImplementedError(
                f"coarsening algorithm {ctx.coarsening.algorithm.value!r} "
                "is not ported yet"
            )
        self.ctx = ctx
        self.levels: List[CoarseningLevel] = []
        self.current = graph
        self.current_n = n
        self.total_node_weight = int(ctx.partition.total_node_weight)
        lp_ctx = ctx.coarsening.clustering.lp
        self._lp_cfg = LPConfig(
            num_iterations=lp_ctx.num_iterations,
            participation=lp_ctx.participation,
            allow_tie_moves=lp_ctx.allow_tie_moves,
            use_active_set=lp_ctx.use_active_set,
            two_hop=lp_ctx.two_hop_strategy != TwoHopStrategy.DISABLE,
            cluster_isolated=lp_ctx.isolated_nodes_strategy
            != IsolatedNodesStrategy.KEEP,
            rating=lp_ctx.rating,
            num_slots=lp_ctx.rating_slots,
        )

    def _level_lp_cfg(self, graph: DeviceGraph) -> LPConfig:
        """Per-level rating engine from the measured density and degree
        skew of the real (unpadded) graph, with the density-stepped slot
        budget."""
        n = max(int(self.current_n), 1)
        m = int(graph.m) or int(graph.src.shape[0])
        avg_degree = m / n
        max_degree = int(graph.degrees.max())
        degree_skew = max_degree / max(avg_degree, 1e-9)
        engine, _ = select_engine(
            self._lp_cfg.rating, graph.n_pad, n, m,
            num_slots=self._lp_cfg.num_slots,
            avg_degree=avg_degree, degree_skew=degree_skew,
        )
        slots = self._lp_cfg.num_slots
        if (
            engine == "scatter"
            and avg_degree > slots / 2
            and 4 * n * slots <= 12 * m
        ):
            slots = 2 * slots
        return replace(self._lp_cfg, rating=engine, num_slots=slots)

    @property
    def level(self) -> int:
        return len(self.levels)

    def empty(self) -> bool:
        return not self.levels

    def coarsen(self) -> bool:
        """One coarsening step; False when converged (shrink below the
        convergence threshold, or the limping tail near the limit)."""
        c_ctx = self.ctx.coarsening
        max_cluster_weight = max(
            1,
            c_ctx.max_cluster_weight(
                self.current_n, self.total_node_weight, self.ctx.partition
            ),
        )
        seed = (self.ctx.seed * 7919 + self.level * 31337) & 0x7FFFFFFF
        mcw = min(max_cluster_weight, WMAX)
        cluster_input = self.current
        if (
            c_ctx.algorithm == CoarseningAlgorithm.SPARSIFICATION_CLUSTERING
            and self.current.m > SPARSIFY_MIN_EDGES
        ):
            # cluster a sparsified copy, contract the true graph: the
            # hierarchy holds unmutated graphs
            cluster_input = sparsify_edges(
                self.current, c_ctx.sparsification_keep_ratio, seed ^ 0x51A5
            )
        lp_cfg = self._level_lp_cfg(cluster_input)

        labels = lp_cluster(cluster_input, mcw, seed, lp_cfg)
        coarse, c_n, c_m = contract_clustering(self.current, labels)

        # forced-shrink retries: relax the cap and re-cluster while the
        # graph stalls far above the contraction limit
        retries = 0
        while (
            c_n >= (1.0 - c_ctx.convergence_threshold) * self.current_n
            and self.current_n > 4 * c_ctx.contraction_limit
            and retries < 3
        ):
            retries += 1
            mcw = min(mcw * 2, WMAX)
            labels = lp_cluster(cluster_input, mcw, seed + retries * 977,
                                lp_cfg)
            coarse, c_n, c_m = contract_clustering(self.current, labels)

        if (
            c_n >= (1.0 - c_ctx.convergence_threshold) * self.current_n
            and self.current_n > 4 * c_ctx.contraction_limit
        ):
            # last resort: the hashed-slot engine sees more candidate
            # clusters per node than sort2's top-K
            hash_cfg = replace(self._lp_cfg, rating="hash")
            labels = lp_cluster(cluster_input, mcw, seed + 3989, hash_cfg)
            coarse, c_n, c_m = contract_clustering(self.current, labels)

        if c_n >= (1.0 - c_ctx.convergence_threshold) * self.current_n:
            return False
        if (
            c_n >= (1.0 - c_ctx.stall_threshold) * self.current_n
            and self.current_n <= 8 * c_ctx.contraction_limit
        ):
            return False  # limping-tail cutoff
        self.levels.append(
            CoarseningLevel(
                fine_graph=self.current,
                coarse=coarse,
                fine_n=self.current_n,
                coarse_n=c_n,
                coarse_m=c_m,
            )
        )
        self.current = coarse.graph
        self.current_n = c_n
        return True

    def uncoarsen(
        self, partition: torch.Tensor
    ) -> Tuple[DeviceGraph, torch.Tensor]:
        """Pop one level and project the coarse partition up; returns
        (fine graph, fine partition)."""
        level = self.levels.pop()
        fine_part = level.coarse.project_up(partition)
        self.current = level.fine_graph
        self.current_n = level.fine_n
        return level.fine_graph, fine_part
