"""k-way multilevel partitioner (counterpart of
kaminpar_tpu/partitioning/kway.py; kway_multilevel.cc): coarsen on the
device until n <= k * contraction_limit (kway_multilevel.cc:144-146),
partition the coarsest graph into k blocks on the host by recursive
bisection, then uncoarsen with the refiner pipeline at k on every level,
and end with the exact host balance backstop.  Coarsening levels, the
initial partition and the uncoarsening levels are checkpoint barriers
(resilience/checkpoint.py), as in the deep scheme, and the debug dumps
(partitioning/debug.py) sit where the JAX package has them.  Its quality
hooks are not part of this package.
"""

from __future__ import annotations

import numpy as np

from .. import telemetry
from ..graphs.csr import device_graph_from_host, host_graph_from_device
from ..graphs.host import HostGraph
from ..resilience import checkpoint as ckpt
from ..resilience import memory as memory_mod
from ..utils.rng import host_rng
from . import debug
from .base import MultilevelScheme
from .coarsener import Coarsener, newest_level_snapshot, restore_levels
from .rb import recursive_bipartition
from .refiner import RefinerPipeline


class KWayMultilevelPartitioner(MultilevelScheme):
    @staticmethod
    def _ckpt_state_payload(partition, n: int) -> dict:
        return {"state": {
            "partition": partition[:n].cpu().numpy().astype(np.int32),
        }}

    def partition(self, graph: HostGraph) -> np.ndarray:
        ctx = self.ctx
        k = ctx.partition.k
        rng = host_rng(ctx.seed, ctx.seed)
        memory_mod.preflight(graph.n, graph.m, k, where="kway")
        with self._phase("upload"):
            dgraph = device_graph_from_host(graph, self.device)
        max_bw, min_bw = self._final_block_weights()

        coarsener = Coarsener(ctx, dgraph, graph.n)
        threshold = max(k * ctx.coarsening.contraction_limit, 1)

        resume = ckpt.take_resume("kway")
        stage = None
        partition = None
        num_levels = None
        if resume is not None:
            stage = resume["stage"]
            meta = resume.get("meta", {})
            restored = restore_levels(coarsener, dgraph, resume["arrays"])
            num_levels = meta.get("num_levels")
            st = resume["arrays"].get("state")
            if st is not None:
                partition = self._pad_partition(
                    np.asarray(st["partition"], dtype=np.int32),
                    coarsener.current.n_pad,
                )
            telemetry.event("resume", scheme="kway", stage=stage,
                            level=resume.get("level"),
                            levels_restored=restored)

        if stage is None or stage == "coarsen":
            with self._phase("coarsening"):
                while coarsener.current_n > threshold:
                    if not coarsener.coarsen():
                        break
                    if ctx.debug.dump_graph_hierarchy:
                        debug.dump_graph_hierarchy(
                            ctx, host_graph_from_device(coarsener.current),
                            coarsener.level,
                        )
                    if not ckpt.barrier(
                        "coarsen", level=coarsener.level, scheme="kway",
                        payload=lambda: {
                            f"level-{coarsener.level - 1}":
                                newest_level_snapshot(coarsener)
                        },
                        keep=[f"level-{j}"
                              for j in range(coarsener.level - 1)],
                    ):
                        break  # wind-down
        self.levels = [(graph.n, graph.m)] + [
            (lvl.coarse_n, lvl.coarse_m) for lvl in coarsener.levels
        ]

        if stage in (None, "coarsen"):
            with self._phase("initial-partitioning"):
                coarsest_host = host_graph_from_device(coarsener.current)
                debug.dump_coarsest_graph(ctx, coarsest_host)
                init_part = recursive_bipartition(coarsest_host, k, ctx, rng)
                debug.dump_coarsest_partition(ctx, init_part)
                partition = self._pad_partition(
                    init_part, coarsener.current.n_pad)
            num_levels = coarsener.level + 1
            ckpt.barrier(
                "initial", level=coarsener.level, scheme="kway",
                payload=lambda: self._ckpt_state_payload(
                    partition, coarsener.current_n),
                keep=[f"level-{j}" for j in range(coarsener.level)],
                meta={"num_levels": num_levels},
            )
        if num_levels is None:
            num_levels = coarsener.level + 1

        refiner = RefinerPipeline(ctx, k)
        # per-level partition dumps are staged, as in the deep scheme
        pending_dumps = []
        with self._phase("uncoarsening"):
            level = coarsener.level
            if stage != "uncoarsen":
                partition = refiner.refine(
                    coarsener.current, partition, max_bw, min_bw,
                    seed=ctx.seed, level=level, num_levels=num_levels,
                )
                part_now = partition
                ckpt.barrier(
                    "uncoarsen", level=level, scheme="kway",
                    payload=lambda: self._ckpt_state_payload(
                        part_now, coarsener.current_n),
                    keep=[f"level-{j}" for j in range(level)],
                    meta={"num_levels": num_levels},
                )
            while not coarsener.empty():
                fine_graph, partition = coarsener.uncoarsen(partition)
                level -= 1
                partition = refiner.refine(
                    fine_graph, partition, max_bw, min_bw,
                    seed=ctx.seed, level=level, num_levels=num_levels,
                )
                if ctx.debug.dump_partition_hierarchy:
                    pending_dumps.append(
                        (level, partition.clone(), coarsener.current_n))
                part_now = partition
                ckpt.barrier(
                    "uncoarsen", level=level, scheme="kway",
                    payload=lambda: self._ckpt_state_payload(
                        part_now, coarsener.current_n),
                    keep=[f"level-{j}" for j in range(level)],
                    meta={"num_levels": num_levels},
                )
            partition = refiner.enforce_balance_host(
                dgraph, partition, np.asarray(ctx.partition.max_block_weights),
                where="kway",
            )
        for dump_level, dump_part, dump_n in pending_dumps:
            debug.dump_partition_hierarchy(
                ctx, dump_part[:dump_n].cpu().numpy(), dump_level)
        return partition[: graph.n].cpu().numpy()
