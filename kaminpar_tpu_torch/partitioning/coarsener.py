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
`coarsening-level`).  Each accepted level passes the integrity sentinels
(resilience/integrity.py) before it joins the hierarchy.  Under the memory
governor's rung 2 the cold levels are spilled to host memory at the
barriers and re-uploaded into their own pad buckets during uncoarsening
(`spill_cold_levels`); `newest_level_snapshot` and `restore_levels` are
the deep and k-way schemes' checkpoint payload and resume.  The JAX
package's quality hooks are not part of this package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..context import (
    CoarseningAlgorithm,
    Context,
    IsolatedNodesStrategy,
    TwoHopStrategy,
)
from ..dtypes import WMAX
from ..graphs.csr import (
    DeviceGraph,
    device_graph_from_host,
    host_graph_from_device,
)
from ..graphs.host import HostGraph
from ..ops.gather import gather_i32
from ..ops.contraction import CoarseGraph, contract_clustering
from ..ops.lp import LPConfig, lp_cluster
from ..ops.rating import select_engine
from ..ops.segments import combine_labels
from ..ops.sparsify import sparsify_edges
from ..resilience import integrity as integrity_mod
from ..resilience import memory as memory_mod
from ..utils import timer
from .. import telemetry

# sparsification clusters levels with more edges than this
SPARSIFY_MIN_EDGES = 1 << 16


@dataclass
class CoarseningLevel:
    """One hierarchy step.  ``fine_graph`` and ``coarse`` are None while
    the level is spilled to the host (``spilled`` then holds its coarse
    host CSR, cmap and pad bucket)."""

    fine_graph: Optional[DeviceGraph]
    coarse: Optional[CoarseGraph]
    fine_n: int
    coarse_n: int
    coarse_m: int
    spilled: Optional[dict] = None


class Coarsener:
    """Cluster coarsener with hierarchy (coarsener.h:20-88 interface)."""

    def __init__(self, ctx: Context, graph: DeviceGraph, n: int):
        self.ctx = ctx
        self.levels: List[CoarseningLevel] = []
        self.current = graph
        self.current_n = n
        # the input level: uncoarsening falls back to it when the level
        # above it was spilled
        self._input_graph = graph
        # the memory governor's spill target (no-op while it is dormant)
        memory_mod.register_spiller(self)
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
        # integrity sentinels on the accepted level, after the chaos
        # hook; a violation fires before this level's barrier, so the
        # manifest still points at the last clean one
        coarse = integrity_mod.chaos_corrupt_contraction(coarse)
        integrity_mod.check_contraction(
            self.current, coarse.cmap, coarse.graph, level=self.level,
            fine_n=self.current_n, coarse_n=c_n,
        )
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
        (fine graph, fine partition).  A spilled level below is restored
        first (its coarse graph is the popped level's fine graph), and a
        spilled projection map is uploaded from its host copy."""
        if len(self.levels) >= 2:
            self._restore_level(len(self.levels) - 2)
        level = self.levels.pop()
        if level.coarse is not None:
            cmap = level.coarse.cmap
        else:
            cmap = torch.from_numpy(np.asarray(
                level.spilled["cmap"], dtype=np.int32)).to(partition.device)
            memory_mod.note_reload(cmap.numel() * cmap.element_size())
        fine = level.fine_graph
        if fine is None:
            fine = (self.levels[-1].coarse.graph if self.levels
                    else self._input_graph)
        fine_part = gather_i32(partition, cmap)
        self.current = fine
        self.current_n = level.fine_n
        return fine, fine_part

    # -- host spill / reload (the memory governor's rung 2) -------------

    @staticmethod
    def _level_device_bytes(lvl: CoarseningLevel) -> int:
        g = lvl.coarse.graph
        return sum(t.numel() * t.element_size()
                   for t in (g.row_ptr, g.src, g.dst, g.edge_w, g.node_w,
                             lvl.coarse.cmap))

    def spill_cold_levels(self, keep_last: int = 1) -> int:
        """Copy every level but the newest ``keep_last`` to the host and
        drop its device tensors; returns the device bytes released."""
        freed = 0
        for i in range(len(self.levels) - max(0, keep_last)):
            lvl = self.levels[i]
            if lvl.coarse is None or lvl.spilled is not None:
                continue
            freed += self._spill_level(i)
        return freed

    def _spill_level(self, i: int) -> int:
        lvl = self.levels[i]
        g = lvl.coarse.graph
        nbytes = self._level_device_bytes(lvl)
        hg = host_graph_from_device(g)
        lvl.spilled = {
            "xadj": hg.xadj,
            "adjncy": hg.adjncy,
            "node_w": hg.node_weight_array(),
            "edge_w": hg.edge_weight_array(),
            "cmap": lvl.coarse.cmap.cpu().numpy(),
            "n_pad": int(g.n_pad),
            "m_pad": int(g.m_pad),
        }
        # this level's coarse graph is the next level's fine graph (the
        # same object): both references go, or nothing is released
        lvl.coarse = None
        if i + 1 < len(self.levels):
            self.levels[i + 1].fine_graph = None
        memory_mod.note_spill(nbytes)
        telemetry.event("memory-spill", level=i, bytes=nbytes,
                        n=lvl.coarse_n, m=lvl.coarse_m)
        return nbytes

    def _restore_level(self, i: int) -> None:
        """Re-upload a spilled level into the pad bucket it was spilled
        from, whatever pad policy is active now."""
        lvl = self.levels[i]
        if lvl.coarse is not None:
            return
        sp = lvl.spilled
        edge_w = sp["edge_w"]
        hg = HostGraph(
            xadj=sp["xadj"],
            adjncy=sp["adjncy"],
            node_weights=sp["node_w"],
            edge_weights=edge_w if edge_w.size else None,
        )
        dev = self._input_graph.device
        dg = device_graph_from_host(hg, dev, n_pad=sp["n_pad"],
                                    m_pad=sp["m_pad"])
        lvl.coarse = CoarseGraph(graph=dg, cmap=torch.from_numpy(
            np.asarray(sp["cmap"], dtype=np.int32)).to(dev))
        lvl.spilled = None
        if i + 1 < len(self.levels):
            self.levels[i + 1].fine_graph = dg
        nbytes = self._level_device_bytes(lvl)
        memory_mod.note_reload(nbytes)
        telemetry.event("memory-reload", level=i, bytes=nbytes,
                        n=lvl.coarse_n, m=lvl.coarse_m)


# ---------------------------------------------------------------------------
# hierarchy checkpoints: one level as its coarse host CSR and projection
# map, and the inverse (the deep and k-way schemes)
# ---------------------------------------------------------------------------


def newest_level_snapshot(coarsener: Coarsener) -> dict:
    """The just-contracted level as host arrays: the coarse CSR, the
    projection map, its sizes and its pad bucket (a resume re-uploads
    into exactly this bucket under any pad policy).  Reads the level off
    the device; called only when a checkpoint manager is armed."""
    lvl = coarsener.levels[-1]
    g = lvl.coarse.graph
    hg = host_graph_from_device(g)
    return {
        "xadj": hg.xadj,
        "adjncy": hg.adjncy,
        "node_w": hg.node_weight_array(),
        "edge_w": hg.edge_weight_array(),
        "cmap": lvl.coarse.cmap.cpu().numpy(),
        "dims": np.asarray([lvl.fine_n, lvl.coarse_n, lvl.coarse_m],
                           dtype=np.int64),
        "pads": np.asarray([g.n_pad, g.m_pad], dtype=np.int64),
    }


def restore_levels(coarsener: Coarsener, dgraph: DeviceGraph,
                   arrays: dict) -> int:
    """Rebuild the hierarchy from `level-<i>` snapshots: re-upload each
    coarse CSR into its recorded pad bucket and reattach the projection
    maps.  Returns the number of levels restored."""
    names = sorted((nm for nm in arrays if nm.startswith("level-")),
                   key=lambda s: int(s.split("-", 1)[1]))
    graphs = [dgraph]
    dev = dgraph.device
    for nm in names:
        a = arrays[nm]
        fine_n, coarse_n, coarse_m = (int(x) for x in a["dims"])
        hg = HostGraph(
            xadj=a["xadj"],
            adjncy=a["adjncy"],
            node_weights=a["node_w"],
            edge_weights=a["edge_w"] if a["edge_w"].size else None,
        )
        if "pads" in a:
            n_pad, m_pad = (int(x) for x in a["pads"])
            dg = device_graph_from_host(hg, dev, n_pad=n_pad, m_pad=m_pad)
        else:
            dg = device_graph_from_host(hg, dev)
        coarse = CoarseGraph(graph=dg, cmap=torch.from_numpy(
            np.asarray(a["cmap"], dtype=np.int32)).to(dev))
        coarsener.levels.append(CoarseningLevel(
            fine_graph=graphs[-1], coarse=coarse, fine_n=fine_n,
            coarse_n=coarse_n, coarse_m=coarse_m,
        ))
        graphs.append(dg)
    if coarsener.levels:
        coarsener.current = graphs[-1]
        coarsener.current_n = coarsener.levels[-1].coarse_n
    return len(names)
