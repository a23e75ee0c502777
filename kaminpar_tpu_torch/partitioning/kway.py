"""k-way multilevel partitioner (counterpart of
kaminpar_tpu/partitioning/kway.py; kway_multilevel.cc): coarsen on the
device until n <= k * contraction_limit (kway_multilevel.cc:144-146),
partition the coarsest graph into k blocks on the host by recursive
bisection, then uncoarsen with the refiner pipeline at k on every level,
and end with the exact host balance backstop.  The JAX package's
checkpoint, quality and memory hooks are not part of this package.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import device_graph_from_host, host_graph_from_device
from ..graphs.host import HostGraph
from ..utils.rng import host_rng
from .base import MultilevelScheme
from .coarsener import Coarsener
from .rb import recursive_bipartition
from .refiner import RefinerPipeline


class KWayMultilevelPartitioner(MultilevelScheme):
    def partition(self, graph: HostGraph) -> np.ndarray:
        ctx = self.ctx
        k = ctx.partition.k
        rng = host_rng(ctx.seed, ctx.seed)
        with self._phase("upload"):
            dgraph = device_graph_from_host(graph, self.device)
        max_bw, min_bw = self._final_block_weights()

        coarsener = Coarsener(ctx, dgraph, graph.n)
        threshold = max(k * ctx.coarsening.contraction_limit, 1)
        with self._phase("coarsening"):
            while coarsener.current_n > threshold:
                if not coarsener.coarsen():
                    break
        self.levels = [(graph.n, graph.m)] + [
            (lvl.coarse_n, lvl.coarse_m) for lvl in coarsener.levels
        ]

        with self._phase("initial-partitioning"):
            coarsest_host = host_graph_from_device(coarsener.current)
            partition = self._pad_partition(
                recursive_bipartition(coarsest_host, k, ctx, rng),
                coarsener.current.n_pad,
            )
        num_levels = coarsener.level + 1

        refiner = RefinerPipeline(ctx, k)
        with self._phase("uncoarsening"):
            level = coarsener.level
            partition = refiner.refine(
                coarsener.current, partition, max_bw, min_bw,
                seed=ctx.seed, level=level, num_levels=num_levels,
            )
            while not coarsener.empty():
                fine_graph, partition = coarsener.uncoarsen(partition)
                level -= 1
                partition = refiner.refine(
                    fine_graph, partition, max_bw, min_bw,
                    seed=ctx.seed, level=level, num_levels=num_levels,
                )
            partition = refiner.enforce_balance_host(
                dgraph, partition, np.asarray(ctx.partition.max_block_weights),
                where="kway",
            )
        return partition[: graph.n].cpu().numpy()
