"""Refinement pipeline (counterpart of kaminpar_tpu/partitioning/refiner.py):
runs the context's refiner list in order — overload balancer, underload
balancer, Jet and LP refinement on the device, k-way FM and the gated
Mt-KaHyPar adapter on the host — plus the exact host balance backstop.

Each step runs under the degradation contract (`refiner`: a failed step
rolls back to its input; `device-balancer`: the exact host balancer), the
integrity sentinels check each pass, and after a deadline no further step
starts (a `refine-skipped` event).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..context import Context, RefinementAlgorithm
from ..dtypes import ACC_DTYPE
from ..graphs.csr import DeviceGraph, host_graph_from_device
from ..ops import balancer as balancer_ops
from ..ops import metrics
from ..ops.jet import jet_refine
from ..ops.lp import LPConfig, lp_refine
from ..ops.segments import pad_k_bucket
from ..refinement.fm import fm_refine_host
from ..refinement.mtkahypar import mtkahypar_refine_host
from ..resilience import deadline as deadline_mod
from ..resilience import integrity as integrity_mod
from ..resilience.faults import maybe_inject
from ..resilience.policy import with_fallback
from .. import telemetry


class RefinerPipeline:
    """Runs the context's refiner list in order (MultiRefiner analog).
    `light=True` gives Jet a single round (an intermediate k-doubling
    extension that another doubling follows at once)."""

    def __init__(self, ctx: Context, k: int, light: bool = False):
        self.ctx = ctx
        self.k = k
        self.light = light
        self._lp_cfg = LPConfig(
            num_iterations=ctx.refinement.lp.num_iterations,
            participation=ctx.refinement.lp.participation,
            allow_tie_moves=False,
            use_active_set=True,
            refinement=True,
        )

    def refine(
        self,
        graph: DeviceGraph,
        partition: torch.Tensor,
        max_block_weights: torch.Tensor,
        min_block_weights: Optional[torch.Tensor],
        seed: int,
        level: int = 0,
        num_levels: int = 1,
    ) -> torch.Tensor:
        """Run the refiner list on one level.  A `device-oom` fault site
        at entry (outside the per-step rollbacks, so the memory governor's
        ladder answers it); the integrity sentinels probe the partition
        before and after the pass."""
        maybe_inject("device-oom")
        k, max_block_weights, min_block_weights = pad_k_bucket(
            self.k, max_block_weights, min_block_weights
        )
        before = integrity_mod.refine_probe(
            graph, partition, max_block_weights, min_block_weights
        )
        refined = self._refine_steps(
            graph, partition, k, max_block_weights, min_block_weights,
            seed, level, num_levels,
        )
        refined = integrity_mod.chaos_corrupt_partition(refined)
        after = integrity_mod.refine_probe(
            graph, refined, max_block_weights, min_block_weights
        )
        integrity_mod.check_refinement(before, after, k=int(k), level=level)
        if after is not None:
            integrity_mod.audit_refine_cut(graph, refined, after[0],
                                           level=level)
        return refined

    def _refine_steps(self, graph, partition, k, max_block_weights,
                      min_block_weights, seed, level, num_levels):
        for i, algorithm in enumerate(self.ctx.refinement.algorithms):
            # anytime wind-down: once the deadline passed, no refiner step
            # starts; the schemes' balance backstop and the output gate
            # keep the balance guarantee
            if deadline_mod.should_stop():
                telemetry.event("refine-skipped", level=level,
                                algorithm=algorithm.value, reason="deadline")
                break
            salt = (seed * 2654435761 + i * 40503 + level) & 0x7FFFFFFF
            if algorithm == RefinementAlgorithm.NOOP:
                continue
            step = self._make_step(
                algorithm, graph, k, max_block_weights, min_block_weights,
                salt, seed + i, level, num_levels,
            )
            if step is None:
                continue
            # a failed step (device OOM, a refusal, an injected fault) rolls
            # back to its input partition; the balancer step degrades to
            # the exact host balancer instead
            prev = partition
            if algorithm == RefinementAlgorithm.OVERLOAD_BALANCER:
                partition = with_fallback(
                    lambda s=step: s(prev),
                    lambda exc: self._host_balance(
                        graph, prev, max_block_weights.cpu().numpy()
                    ),
                    site="device-balancer",
                    where=f"level{level}",
                )
            else:
                partition = with_fallback(
                    lambda s=step: s(prev),
                    lambda exc: prev,
                    site="refiner",
                    where=f"{algorithm.value}@level{level}",
                )
        return partition

    def _make_step(self, algorithm, graph, k, max_block_weights,
                   min_block_weights, salt, seed, level, num_levels):
        """One refinement algorithm as a partition -> partition closure
        (the unit the degradation contract wraps); None: skipped."""
        if algorithm == RefinementAlgorithm.LABEL_PROPAGATION:
            def step(partition):
                return lp_refine(graph, partition, k, max_block_weights,
                                 salt, self._lp_cfg)
        elif algorithm == RefinementAlgorithm.OVERLOAD_BALANCER:
            def step(partition):
                return balancer_ops.overload_balance(
                    graph, partition, k, max_block_weights, salt,
                    max_rounds=self.ctx.refinement.balancer.max_rounds,
                )
        elif algorithm == RefinementAlgorithm.UNDERLOAD_BALANCER:
            if min_block_weights is None:
                return None

            def step(partition):
                return balancer_ops.underload_balance(
                    graph, partition, k, max_block_weights,
                    min_block_weights, salt,
                    max_rounds=self.ctx.refinement.balancer.max_rounds,
                )
        elif algorithm == RefinementAlgorithm.JET:
            jet_ctx = self.ctx.refinement.jet
            if self.light:
                jet_ctx = dataclasses.replace(
                    jet_ctx,
                    num_rounds_on_fine_level=1,
                    num_rounds_on_coarse_level=1,
                )

            def step(partition):
                return jet_refine(
                    graph, partition, k, max_block_weights, salt, jet_ctx,
                    level=level, num_levels=num_levels,
                )
        elif algorithm == RefinementAlgorithm.GREEDY_FM:
            # FM earns its host round trip on the finest levels only;
            # light intermediate extensions skip it, as they skip full Jet
            if self.light or level > self.ctx.refinement.fm.max_level:
                return None

            def step(partition):
                # host refiners see the real k, not the padded bucket
                return fm_refine_host(
                    graph, partition, self.k,
                    max_block_weights[: self.k], self.ctx.refinement.fm,
                    seed=seed, threads=self.ctx.parallel.num_workers,
                )
        elif algorithm == RefinementAlgorithm.MTKAHYPAR:
            def step(partition):
                host = host_graph_from_device(graph)
                refined = mtkahypar_refine_host(
                    host, partition[: host.n].cpu().numpy(), self.k,
                    max_block_weights=max_block_weights[: self.k].cpu()
                    .numpy(),
                    epsilon=self.ctx.partition.epsilon, seed=seed,
                    threads=self.ctx.parallel.num_workers,
                )
                full = torch.zeros(graph.n_pad, dtype=torch.int32)
                full[: host.n] = torch.from_numpy(refined)
                return full.to(graph.device)
        else:
            raise ValueError(f"unknown refinement algorithm: {algorithm!r}")
        return step

    def _host_balance(
        self, graph: DeviceGraph, partition: torch.Tensor,
        max_block_weights: np.ndarray,
    ) -> torch.Tensor:
        """The exact host balancer as a device-partition transform."""
        host = host_graph_from_device(graph)
        n = host.n
        part_h = partition[:n].cpu().numpy().copy()
        balanced = balancer_ops.host_balance(
            host.node_weight_array(),
            (host.xadj, host.adjncy, host.edge_weight_array()),
            part_h,
            np.asarray(max_block_weights),
        )
        full = np.zeros(graph.n_pad, dtype=np.int32)
        full[:n] = balanced
        return torch.from_numpy(full).to(graph.device)

    def enforce_balance_host(
        self, graph: DeviceGraph, partition: torch.Tensor,
        max_block_weights: np.ndarray, where: str = "",
    ) -> torch.Tensor:
        """Exact host fallback for the strict balance guarantee when the
        device balancing rounds stalled; `where` names the calling scheme
        in the `balancer-host-fallback` event."""
        caps = torch.as_tensor(
            np.asarray(max_block_weights).astype(np.int32), dtype=ACC_DTYPE,
            device=graph.device,
        )
        over = int(metrics.total_overload(graph, partition, caps))
        if over == 0:
            return partition
        telemetry.event("balancer-host-fallback", residual_overload=over,
                        where=where or None)
        return self._host_balance(graph, partition, max_block_weights)
