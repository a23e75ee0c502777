"""Device multilevel coarsener (counterpart of
kaminpar_tpu/partitioning/coarsener.py): LP clustering then contraction,
level by level, with the reference's max-cluster-weight formula, the
forced-shrink retries, the hash-engine last resort and the limping-tail
cutoff.  Under SPARSIFICATION_CLUSTERING (linear-time MGP) a level of more
than 2^16 edges is clustered on a sparsified copy (ops/sparsify.py) and
the true graph is contracted; under OVERLAY_CLUSTERING (PASCO) each
clustering is the intersection of `num_overlays` LP clusterings; NOOP
clusters as BASIC does, as in the JAX coarsener.  Each level's engine
choice and accepted level are telemetry events (`rating-engine`,
`coarsening-level`).  The JAX package's spill, checkpoint, integrity and
quality hooks are not part of this package.
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
from ..ops.segments import combine_labels
from ..ops.sparsify import sparsify_edges
from ..utils import timer
from .. import telemetry

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
        engine, reason = select_engine(
            self._lp_cfg.rating, graph.n_pad, n, m,
            num_slots=self._lp_cfg.num_slots,
            avg_degree=avg_degree, degree_skew=degree_skew,
        )
        telemetry.event(
            "rating-engine", level=self.level, engine=engine, reason=reason,
            avg_degree=round(avg_degree, 2),
            degree_skew=round(degree_skew, 2), n=n, m=int(graph.m),
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

        def cluster_once(cap, salt_off):
            if c_ctx.algorithm == CoarseningAlgorithm.OVERLAY_CLUSTERING:
                # PASCO: nodes merge only where every clustering agrees
                labels = None
                for r in range(max(1, c_ctx.clustering.num_overlays)):
                    li = lp_cluster(cluster_input, cap,
                                    seed + 7 * r + 1 + salt_off, lp_cfg)
                    labels = li if labels is None else combine_labels(
                        labels, li)
                return labels
            return lp_cluster(cluster_input, cap, seed + salt_off, lp_cfg)

        def clustered(cluster):
            # the contraction reads sizes back and so waits for the LP;
            # a recorded span waits inside its own scope instead
            with timer.scoped_timer(
                "lp-clustering",
                sync=self.current.device if telemetry.enabled() else None,
            ):
                labels = cluster()
            with timer.scoped_timer("contraction"):
                return contract_clustering(self.current, labels)

        coarse, c_n, c_m = clustered(lambda: cluster_once(mcw, 0))

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
            coarse, c_n, c_m = clustered(
                lambda: cluster_once(mcw, retries * 977))

        if (
            c_n >= (1.0 - c_ctx.convergence_threshold) * self.current_n
            and self.current_n > 4 * c_ctx.contraction_limit
        ):
            # last resort: the hashed-slot engine sees more candidate
            # clusters per node than sort2's top-K
            hash_cfg = replace(self._lp_cfg, rating="hash")
            coarse, c_n, c_m = clustered(lambda: lp_cluster(
                cluster_input, mcw, seed + 3989, hash_cfg))

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
        g = coarse.graph
        telemetry.event(
            "coarsening-level", level=self.level, n=int(c_n), m=int(c_m),
            retries=retries, n_pad=g.n_pad, m_pad=g.m_pad,
            buffer_bytes=sum(
                t.numel() * t.element_size()
                for t in (g.row_ptr, g.src, g.dst, g.edge_w, g.node_w,
                          coarse.cmap)
            ),
        )
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
