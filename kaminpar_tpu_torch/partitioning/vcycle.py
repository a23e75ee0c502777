"""V-cycle partitioner (counterpart of kaminpar_tpu/partitioning/vcycle.py;
vcycle_deep_multilevel.cc): iterated deep multilevel with community
restriction.  A deep multilevel run gives the first partition (unless a
warm start is given); then each v-cycle re-coarsens the graph with LP
clustering restricted to the current blocks (communities), projects the
partition down the new hierarchy, refines it back up and ends with the
exact host balance backstop.  The restriction keeps the projected
partition valid at every level, so a cycle starts from the partition it
was given.  `max_levels` bounds the restricted coarsening of each cycle
(0: refinement at the input level only).  Each finished cycle is a
`vcycle` telemetry event with its cut and a checkpoint barrier, where a
resume re-enters; after a deadline no further cycle starts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..context import PartitioningMode
from ..dtypes import WMAX
from ..graphs.csr import device_graph_from_host
from ..graphs.host import HostGraph, host_partition_metrics
from ..ops.contraction import contract_clustering
from ..ops.lp import LPConfig, lp_cluster
from ..resilience import checkpoint as ckpt
from ..resilience import deadline as deadline_mod
from .base import MultilevelScheme
from .deep import DeepMultilevelPartitioner
from .refiner import RefinerPipeline
from .. import telemetry


class VcycleDeepMultilevelPartitioner(MultilevelScheme):
    def __init__(self, ctx, device,
                 initial_partition: Optional[np.ndarray] = None,
                 max_levels: Optional[int] = None):
        """``initial_partition`` (a valid k-way partition of the graph, as
        a numpy array) warm-starts the cycles in place of the deep run;
        ``max_levels`` bounds each cycle's restricted coarsening (None:
        down to the usual threshold)."""
        super().__init__(ctx, device)
        self.initial_partition = initial_partition
        self.max_levels = max_levels

    def partition(self, graph: HostGraph) -> np.ndarray:
        ctx = self.ctx
        k = ctx.partition.k
        # resume: a `vcycle` checkpoint holds the partition after a
        # finished cycle; a kill during the initial deep run left a `deep`
        # checkpoint, which the deep run below resumes on its own
        resume = ckpt.take_resume("vcycle")
        start_cycle = 0
        part = None
        if resume is not None and "state" in resume["arrays"]:
            part = np.asarray(resume["arrays"]["state"]["partition"],
                              dtype=np.int32)
            start_cycle = int(resume.get("level") or 0) + 1
            telemetry.event("resume", scheme="vcycle", stage=resume["stage"],
                            level=resume.get("level"))
        if part is None and self.initial_partition is not None:
            # the warm start; a resume above wins over it
            part = np.asarray(self.initial_partition, dtype=np.int32)
            if part.shape != (graph.n,):
                raise ValueError(f"warm-start partition shape {part.shape} "
                                 f"!= ({graph.n},)")
            if len(part) and (int(part.min()) < 0 or int(part.max()) >= k):
                raise ValueError("warm-start partition labels out of range "
                                 f"[0, {k})")
        if part is None:
            deep_ctx = ctx.copy()
            deep_ctx.partitioning.mode = PartitioningMode.DEEP
            deep_ctx.partition = ctx.partition  # the configured weights
            deep = DeepMultilevelPartitioner(deep_ctx, self.device)
            part = deep.partition(graph)
            self.timings.update(
                {f"deep/{name}": t for name, t in deep.timings.items()}
            )
            self.levels = deep.levels

        for cycle in range(start_cycle,
                           max(len(ctx.partitioning.vcycles), 1)):
            if deadline_mod.should_stop():
                break  # wind-down: a cycle only improves a valid partition
            with self._phase(f"vcycle-{cycle}"):
                part = self._one_vcycle(graph, part, cycle)
            if telemetry.enabled() and isinstance(graph, HostGraph):
                telemetry.event(
                    "vcycle", cycle=cycle,
                    cut=int(host_partition_metrics(graph, part, k)["cut"]),
                )
            part_now = part
            ckpt.barrier(
                "vcycle", level=cycle, scheme="vcycle",
                payload=lambda: {"state": {
                    "partition": np.asarray(part_now, dtype=np.int32),
                }},
            )
        return part

    def _one_vcycle(self, graph: HostGraph, part: np.ndarray,
                    cycle: int) -> np.ndarray:
        """Community-restricted coarsening, projection down, refinement
        up."""
        ctx = self.ctx
        k = ctx.partition.k
        dgraph = device_graph_from_host(graph, self.device)
        max_bw, min_bw = self._final_block_weights()
        lp_cfg = LPConfig(
            num_iterations=ctx.coarsening.clustering.lp.num_iterations,
            participation=ctx.coarsening.clustering.lp.participation,
        )

        levels = []
        current = dgraph
        current_part = self._pad_partition(part, dgraph.n_pad)
        current_n = graph.n
        threshold = max(2 * ctx.coarsening.contraction_limit, 2)
        while current_n > threshold and (
            self.max_levels is None or len(levels) < self.max_levels
        ):
            max_cw = max(1, ctx.coarsening.max_cluster_weight(
                current_n, ctx.partition.total_node_weight, ctx.partition
            ))
            seed = (ctx.seed * 65713 + cycle * 977
                    + len(levels) * 31337) & 0x7FFFFFFF
            labels = lp_cluster(current, min(max_cw, WMAX), seed, lp_cfg,
                                communities=current_part)
            coarse, c_n, _ = contract_clustering(current, labels)
            if c_n >= (1.0 - ctx.coarsening.convergence_threshold) * current_n:
                break
            # clusters never span blocks, so the partition projects down
            levels.append((current, coarse))
            current_part = coarse.project_down(current_part)
            current = coarse.graph
            current_n = c_n

        refiner = RefinerPipeline(ctx, k)
        num_levels = len(levels) + 1
        current_part = refiner.refine(
            current, current_part, max_bw, min_bw, seed=ctx.seed + cycle,
            level=len(levels), num_levels=num_levels,
        )
        for lvl in range(len(levels) - 1, -1, -1):
            fine_graph, coarse = levels[lvl]
            current_part = refiner.refine(
                fine_graph, coarse.project_up(current_part), max_bw, min_bw,
                seed=ctx.seed + cycle, level=lvl, num_levels=num_levels,
            )
        current_part = refiner.enforce_balance_host(
            dgraph, current_part, np.asarray(ctx.partition.max_block_weights),
            where="vcycle",
        )
        return current_part[: graph.n].cpu().numpy()
