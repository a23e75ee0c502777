"""Recursive bipartitioning scheme (counterpart of
kaminpar_tpu/partitioning/rb_scheme.py; rb_multilevel.cc): partition into
two, recurse per block, each bisection a full multilevel bipartition on
the host (partitioning/rb.py).  With
ctx.partitioning.rb_enable_kway_toplevel_refinement the k-way partition is
then refined on the device with the context's refiner pipeline and
balanced by the exact host backstop, as in the JAX package; the
`rb-toplevel` barrier before it only gates that refinement on the
deadline.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import device_graph_from_host
from ..graphs.host import HostGraph
from ..resilience import checkpoint as ckpt
from ..utils.rng import host_rng
from .base import MultilevelScheme
from .rb import recursive_bipartition
from .refiner import RefinerPipeline


class RBMultilevelPartitioner(MultilevelScheme):
    def partition(self, graph: HostGraph) -> np.ndarray:
        ctx = self.ctx
        k = ctx.partition.k
        rng = host_rng(ctx.seed, ctx.seed ^ 0x5B)
        self.levels = [(graph.n, graph.m)]
        with self._phase("recursive-bipartitioning"):
            part = recursive_bipartition(graph, k, ctx, rng)
        # a barrier without a payload (the bisection tree has no
        # hierarchy to snapshot): the deadline's wind-down skips the
        # optional top-level refinement
        proceed = ckpt.barrier("rb-toplevel", scheme="rb")
        if not (proceed
                and ctx.partitioning.rb_enable_kway_toplevel_refinement):
            return part

        with self._phase("toplevel-refinement"):
            dgraph = device_graph_from_host(graph, self.device)
            max_bw, min_bw = self._final_block_weights()
            refiner = RefinerPipeline(ctx, k)
            refined = refiner.refine(
                dgraph, self._pad_partition(part, dgraph.n_pad), max_bw,
                min_bw, seed=ctx.seed,
            )
            refined = refiner.enforce_balance_host(
                dgraph, refined, np.asarray(ctx.partition.max_block_weights),
                where="rb",
            )
        return refined[: graph.n].cpu().numpy()
