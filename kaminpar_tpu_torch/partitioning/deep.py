"""Deep multilevel partitioner (counterpart of
kaminpar_tpu/partitioning/deep.py; ESA'21, deep_multilevel.cc): coarsen on
the device until n <= 2 * contraction_limit, bipartition the coarsest graph
on the host, then uncoarsen while doubling k — after each projection the
partition is refined and, when the level is large enough for more blocks,
extended by bipartitioning each block's induced subgraph.

Block bookkeeping: current block b spans the final blocks [first(b),
first(b) + count(b)); an extension splits a block into ceil/floor halves,
preserving block order, so at k == input k the block ids are the final
ids.  Every coarsening level, the initial partition and every
uncoarsening level is a checkpoint barrier (resilience/checkpoint.py): it
offers the level or the partition to an armed manager, honors the
deadline's wind-down and is where a resume re-enters.  The debug dumps
(partitioning/debug.py) and the heap profiler's device samples sit where
the JAX package has them; its quality hooks are not part of this
package.  Wall times per
phase land in `timings` (the extension time is also counted inside
"uncoarsening"), and the (n, m) of every level of the hierarchy, input
first, in `levels`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..context import Context
from ..dtypes import WMAX
from ..graphs.compressed import CompressedHostGraph
from ..graphs.csr import (
    DeviceGraph,
    device_graph_from_compressed,
    device_graph_from_host,
    host_graph_from_device,
    shape_floors,
)
from ..graphs.host import HostGraph, extract_block_subgraphs
from ..initial import InitialMultilevelBipartitioner
from ..ops.contraction import contract_clustering
from ..ops.jet import jet_refine
from ..ops.lp import lp_cluster, lp_refine
from ..ops.subgraphs import (
    assemble_extended_partition,
    extract_blocks_device,
    host_graph_from_padded,
    scatter_block_bipartition,
    slice_block,
)
from ..resilience import checkpoint as ckpt
from ..resilience import memory as memory_mod
from ..utils.heap_profiler import sample_device_memory
from ..utils.rng import host_rng
from . import debug
from .base import MultilevelScheme
from .coarsener import Coarsener, newest_level_snapshot, restore_levels
from .rb import bipartition_max_block_weights, split_k
from .refiner import RefinerPipeline
from .. import telemetry


@dataclass
class _BlockSpan:
    first: int  # first final block
    count: int  # number of final blocks


# Levels with at least this many edge slots extend the partition with the
# device extraction; smaller levels read the graph back and extract on the
# host (the JAX package's threshold; tests lower it in both packages).
DEVICE_EXTEND_MIN_EDGE_SLOTS = 1 << 22


def compute_k_for_n(n: int, ctx: Context) -> int:
    """partition_utils.cc:94-101."""
    C = ctx.coarsening.contraction_limit
    if n < 2 * C:
        return 2
    k_prime = 1 << max(1, (int(np.ceil(np.log2(max(n / C, 2.0))))))
    return int(np.clip(k_prime, 2, ctx.partition.k))


class DeepMultilevelPartitioner(MultilevelScheme):
    def __init__(self, ctx: Context, device: torch.device):
        super().__init__(ctx, device)
        self._spans: List[_BlockSpan] = []
        self._streamed_input = False

    def partition(self, graph) -> np.ndarray:
        """Partition a HostGraph, or a CompressedHostGraph, which is
        uploaded chunk by chunk: its flat CSR never exists on the host."""
        ctx = self.ctx
        input_k = ctx.partition.k
        rng = host_rng(ctx.seed, ctx.seed ^ 0xDEE9)
        # refuse an upload the governor's rung cannot fit, before a byte
        # lands on the device (the facade's ladder moves on)
        memory_mod.preflight(graph.n, graph.m, input_k, where="deep")

        with self._phase("upload"):
            self._streamed_input = isinstance(graph, CompressedHostGraph)
            if self._streamed_input:
                dgraph = device_graph_from_compressed(graph, self.device)
            else:
                dgraph = device_graph_from_host(graph, self.device)

        coarsener = Coarsener(ctx, dgraph, graph.n)
        threshold = max(2 * ctx.coarsening.contraction_limit, 2)

        # resume: rebuild the recorded hierarchy and state, re-enter at
        # the recorded stage
        resume = ckpt.take_resume("deep")
        stage = None
        partition = None
        spans: List[_BlockSpan] = []
        current_k = 0
        num_levels = None
        if resume is not None:
            stage, partition, spans, current_k, num_levels, rng = (
                self._restore_from_checkpoint(resume, coarsener, dgraph, rng)
            )

        if stage is None or stage == "coarsen":
            with self._phase("coarsening"):
                while coarsener.current_n > threshold:
                    if not coarsener.coarsen():
                        break
                    sample_device_memory()  # per-level live device peak
                    if ctx.debug.dump_graph_hierarchy:
                        debug.dump_graph_hierarchy(
                            ctx, host_graph_from_device(coarsener.current),
                            coarsener.level,
                        )
                    if not ckpt.barrier(
                        "coarsen", level=coarsener.level, scheme="deep",
                        payload=lambda: self._ckpt_level_payload(coarsener),
                        keep=[f"level-{j}"
                              for j in range(coarsener.level - 1)],
                        meta=self._ckpt_meta(current_k, num_levels, rng),
                    ):
                        break  # wind-down: IP and projection stay
        self.levels = [(graph.n, graph.m)] + [
            (lvl.coarse_n, lvl.coarse_m) for lvl in coarsener.levels
        ]

        if stage in (None, "coarsen"):
            with self._phase("initial-partitioning"):
                coarsest_host = host_graph_from_device(coarsener.current)
                debug.dump_coarsest_graph(ctx, coarsest_host)
                k0, k1 = split_k(input_k)
                spans = (
                    [_BlockSpan(0, k0), _BlockSpan(k0, k1)]
                    if input_k > 1 else [_BlockSpan(0, 1)]
                )
                if input_k == 1:
                    part_host = np.zeros(coarsest_host.n, dtype=np.int32)
                else:
                    max_w = bipartition_max_block_weights(
                        ctx, 0, input_k, coarsest_host.total_node_weight
                    )
                    part_host = (
                        InitialMultilevelBipartitioner(
                            ctx.initial_partitioning)
                        .bipartition(coarsest_host, max_w, rng)
                        .astype(np.int32)
                    )
                current_k = len(spans)
                self._spans = spans
                debug.dump_coarsest_partition(ctx, part_host)
                partition = self._pad_partition(
                    part_host, coarsener.current.n_pad
                )
            num_levels = coarsener.level + 1
            ckpt.barrier(
                "initial", level=coarsener.level, scheme="deep",
                payload=lambda: self._ckpt_state_payload(
                    partition, coarsener.current_n, spans),
                keep=[f"level-{j}" for j in range(coarsener.level)],
                meta=self._ckpt_meta(current_k, num_levels, rng),
            )
        if num_levels is None:
            num_levels = coarsener.level + 1

        # per-level partition dumps are staged: each level's partition is
        # cloned on the device and copied to the host after uncoarsening
        pending_dumps: List[Tuple[int, torch.Tensor, int]] = []
        with self._phase("uncoarsening"):
            level = coarsener.level
            if stage != "uncoarsen":
                partition, spans, current_k = self._extend_and_refine(
                    coarsener.current, coarsener.current_n, partition,
                    spans, current_k, rng, level, num_levels,
                )
                ckpt.barrier(
                    "uncoarsen", level=level, scheme="deep",
                    payload=lambda: self._ckpt_state_payload(
                        partition, coarsener.current_n, spans),
                    keep=[f"level-{j}" for j in range(level)],
                    meta=self._ckpt_meta(current_k, num_levels, rng),
                )
            while not coarsener.empty():
                fine_graph, partition = coarsener.uncoarsen(partition)
                sample_device_memory()  # per-level live device peak
                level -= 1
                partition, spans, current_k = self._extend_and_refine(
                    fine_graph, coarsener.current_n, partition, spans,
                    current_k, rng, level, num_levels,
                )
                if ctx.debug.dump_partition_hierarchy:
                    pending_dumps.append(
                        (level, partition.clone(), coarsener.current_n))
                part_now, spans_now = partition, spans
                ckpt.barrier(
                    "uncoarsen", level=level, scheme="deep",
                    payload=lambda: self._ckpt_state_payload(
                        part_now, coarsener.current_n, spans_now),
                    keep=[f"level-{j}" for j in range(level)],
                    meta=self._ckpt_meta(current_k, num_levels, rng),
                )
            while current_k < input_k:
                partition, spans, current_k = self._extend_partition(
                    coarsener.current, partition, spans, input_k, rng
                )
                partition = self._refine(
                    coarsener.current, partition, current_k, 0, num_levels
                )
            refiner = RefinerPipeline(ctx, current_k)
            partition = refiner.enforce_balance_host(
                dgraph, partition, np.asarray(ctx.partition.max_block_weights),
                where="deep",
            )
        for dump_level, dump_part, dump_n in pending_dumps:
            debug.dump_partition_hierarchy(
                ctx, dump_part[:dump_n].cpu().numpy(), dump_level)
        return partition[: graph.n].cpu().numpy()

    # -- checkpoint payloads and restore --------------------------------

    def _ckpt_level_payload(self, coarsener: Coarsener) -> dict:
        """The just-contracted level as a named snapshot."""
        return {f"level-{coarsener.level - 1}":
                newest_level_snapshot(coarsener)}

    def _ckpt_state_payload(self, partition, n: int, spans) -> dict:
        return {"state": {
            "partition": partition[:n].cpu().numpy().astype(np.int32),
            "spans": np.asarray([[s.first, s.count] for s in spans],
                                dtype=np.int64),
        }}

    def _ckpt_meta(self, current_k, num_levels, rng) -> dict:
        """Driver state beside the arrays, the host RNG's state included:
        a resumed extension must draw what the uninterrupted run drew."""
        return {
            "current_k": int(current_k),
            "num_levels": None if num_levels is None else int(num_levels),
            "rng_state": rng.bit_generator.state,
        }

    def _restore_from_checkpoint(self, resume, coarsener, dgraph, rng):
        """Rebuild the hierarchy (coarsener.restore_levels) and the driver
        state of the checkpointed barrier: partition, block spans,
        current_k and the host RNG stream."""
        arrays = resume["arrays"]
        meta = resume.get("meta", {})
        stage = resume["stage"]
        num_restored = restore_levels(coarsener, dgraph, arrays)
        partition = None
        spans: List[_BlockSpan] = []
        current_k = 0
        if "state" in arrays:
            st = arrays["state"]
            partition = self._pad_partition(
                np.asarray(st["partition"], dtype=np.int32),
                coarsener.current.n_pad,
            )
            spans = [_BlockSpan(int(f), int(c))
                     for f, c in np.asarray(st["spans"]).tolist()]
            current_k = int(meta.get("current_k", len(spans)))
            self._spans = spans
        if meta.get("rng_state"):
            rng = np.random.default_rng(0)
            rng.bit_generator.state = meta["rng_state"]
        telemetry.event("resume", scheme="deep", stage=stage,
                        level=resume.get("level"),
                        levels_restored=num_restored)
        return (stage, partition, spans, current_k,
                meta.get("num_levels"), rng)

    # ------------------------------------------------------------------
    def _extend_and_refine(
        self, dgraph: DeviceGraph, n: int, partition, spans, current_k: int,
        rng, level: int, num_levels: int,
    ):
        ctx = self.ctx
        partition = self._refine(dgraph, partition, current_k, level,
                                 num_levels)
        target_k = min(compute_k_for_n(n, ctx), ctx.partition.k)
        while current_k < target_k:
            partition, spans, current_k = self._extend_partition(
                dgraph, partition, spans,
                min(2 * current_k, ctx.partition.k), rng,
            )
            if ctx.partitioning.refine_after_extending_partition:
                partition = self._refine(
                    dgraph, partition, current_k, level, num_levels,
                    light=(
                        ctx.partitioning.light_intermediate_refinement
                        and current_k < target_k
                    ),
                )
        return partition, spans, current_k

    def _refine(self, dgraph, partition, k, level, num_levels, light=False):
        max_bw, min_bw = self._current_block_weights(k)
        refiner = RefinerPipeline(self.ctx, k, light=light)
        return refiner.refine(
            dgraph, partition, max_bw, min_bw,
            seed=self.ctx.seed + level, level=level, num_levels=num_levels,
        )

    def _current_block_weights(self, k: int):
        """Each current block's cap is the sum of its final sub-blocks'
        caps."""
        spans = self._spans
        assert len(spans) == k, (len(spans), k)
        p = self.ctx.partition
        caps = np.array(
            [p.total_max_block_weights(s.first, s.first + s.count)
             for s in spans],
            dtype=np.int64,
        )
        mins = None
        if p.min_block_weights is not None:
            mins = np.array(
                [int(p.min_block_weights[s.first: s.first + s.count].sum())
                 for s in spans],
                dtype=np.int64,
            )
        return self._weights(caps), self._weights(mins)

    def _device_bipartition(
        self, sub: HostGraph, max_block_weights: np.ndarray, rng
    ) -> np.ndarray:
        dg = device_graph_from_host(sub, self.device)
        part = self._device_bipartition_dev(
            dg, sub.n, sub.m, max_block_weights, rng, host_sub=sub
        )
        return part[: sub.n].cpu().numpy().astype(np.int8)

    def _device_bipartition_dev(
        self, dg: DeviceGraph, n: int, m: int,
        max_block_weights: np.ndarray, rng, host_sub: HostGraph | None = None,
    ) -> torch.Tensor:
        """Bipartition a large block subgraph through the device pipeline:
        LP coarsening + contraction down to the host pool's scale, host
        bipartition of the coarsest graph, 2-way LP refinement per level
        on the way up and a final Jet polish.  Returns a device i32[n_pad]
        0/1 partition."""
        ctx = self.ctx
        ic = ctx.initial_partitioning.coarsening
        seed = int(rng.integers(0, 2**31 - 1))
        max_w = max_block_weights.astype(np.int64, copy=False)
        mcw = max(1, int(ic.cluster_weight_multiplier * max_w.max()))

        levels = []
        current, cur_n = dg, n
        stop_n = max(2, 2 * ctx.coarsening.contraction_limit)
        while cur_n > stop_n:
            labels = lp_cluster(
                current, min(mcw, WMAX),
                (seed + 31 * len(levels)) & 0x7FFFFFFF,
            )
            coarse, c_n, _ = contract_clustering(current, labels)
            if c_n >= (1.0 - ic.convergence_threshold) * cur_n:
                break
            levels.append((current, coarse))
            current, cur_n = coarse.graph, c_n

        if levels:
            coarsest_host = host_graph_from_device(current)
        elif host_sub is not None:
            coarsest_host = host_sub
        else:
            coarsest_host = host_graph_from_padded(dg, n, m)
        bp = InitialMultilevelBipartitioner(
            ctx.initial_partitioning
        ).bipartition(coarsest_host, max_w, rng)

        part = self._pad_partition(bp.astype(np.int32), current.n_pad)
        caps = torch.as_tensor(
            np.minimum(max_w, WMAX).astype(np.int32), device=self.device
        )
        for lvl, (fine_graph, coarse) in enumerate(reversed(levels)):
            part = coarse.project_up(part)
            part = lp_refine(
                fine_graph, part, 2, caps, (seed ^ 0x5F3759) + 101 * lvl
            )
        return jet_refine(
            dg, part, 2, caps, seed ^ 0x2545F491, ctx.refinement.jet
        )

    def _extend_partition(self, dgraph: DeviceGraph, partition, spans,
                          next_k: int, rng):
        """extend_partition (helper.cc:220,349): bipartition each block
        that still spans more than one final block.  Compressed inputs
        raise the device path's span limit from 64 to 128: the host path
        reads the whole level back."""
        span_limit = 128 if self._streamed_input else 64
        with self._phase("uncoarsening/extension"):
            if (dgraph.m_pad >= DEVICE_EXTEND_MIN_EDGE_SLOTS
                    and len(spans) <= span_limit):
                extractor = "device"
                out = self._extend_partition_device(
                    dgraph, partition, spans, next_k, rng
                )
            else:
                extractor = "host"
                out = self._extend_partition_host(
                    dgraph, partition, spans, next_k, rng
                )
        telemetry.event("extend-partition", k=out[2], extractor=extractor)
        return out

    def _extend_partition_device(self, dgraph, partition, spans, next_k,
                                 rng):
        """Block-major extraction on the device, per-block bipartitions
        (device pipeline for big blocks, host pool for small ones), and
        assembly of the doubled partition on the device."""
        ctx = self.ctx
        current_k = len(spans)
        ext = extract_blocks_device(dgraph, partition, current_k)
        n_floor, m_floor = shape_floors()
        bp_global = torch.zeros(dgraph.n_pad, dtype=torch.int32,
                                device=self.device)
        bipartitioner = InitialMultilevelBipartitioner(
            ctx.initial_partitioning
        )
        new_spans: List[_BlockSpan] = []
        base_ids = np.zeros(current_k, dtype=np.int32)
        is_split = np.zeros(current_k, dtype=bool)
        next_id = 0
        node_start = np.concatenate([[0], np.cumsum(ext.node_counts)])
        for bidx, span in enumerate(spans):
            base_ids[bidx] = next_id
            if span.count <= 1:
                new_spans.append(span)
                next_id += 1
                continue
            is_split[bidx] = True
            sub, n_b, m_b = slice_block(ext, bidx, n_floor, m_floor)
            max_w = bipartition_max_block_weights(
                ctx, span.first, span.count, int(ext.block_weights[bidx])
            )
            if n_b >= ctx.partitioning.device_bipartition_threshold:
                bp = self._device_bipartition_dev(sub, n_b, m_b, max_w, rng)
            else:
                host_sub = host_graph_from_padded(sub, n_b, m_b)
                bp_np = bipartitioner.bipartition(host_sub, max_w, rng)
                bp = self._pad_partition(bp_np.astype(np.int32), sub.n_pad)
            bp_global = scatter_block_bipartition(
                bp_global, bp, int(node_start[bidx]), n_b, sub.n_pad
            )
            k0, k1 = split_k(span.count)
            new_spans.append(_BlockSpan(span.first, k0))
            new_spans.append(_BlockSpan(span.first + k0, k1))
            next_id += 2
        new_part = assemble_extended_partition(
            ext.b, ext.new_id, ext.node_start, bp_global,
            torch.from_numpy(base_ids).to(self.device),
            torch.from_numpy(is_split).to(self.device), current_k,
        )
        self._spans = new_spans
        return new_part, new_spans, len(new_spans)

    def _extend_partition_host(self, dgraph, partition, spans, next_k, rng):
        """Host extraction: read the level back, extract every block's
        subgraph with numpy and bipartition the blocks that split.  With
        ctx.parallel.num_workers > 1 the host bipartitions run on a pool of
        that many threads, each with a seed drawn beforehand; with one
        worker they draw from the shared stream."""
        ctx = self.ctx
        host = host_graph_from_device(dgraph)
        part = partition[: host.n].cpu().numpy().astype(np.int64)
        current_k = len(spans)
        ext = extract_block_subgraphs(host, part, current_k)
        new_spans: List[_BlockSpan] = []
        new_ids_base: List[Tuple[int, int]] = []
        bipartitioner = InitialMultilevelBipartitioner(
            ctx.initial_partitioning
        )
        sub_parts: List = []
        pool_jobs: List[Tuple[int, HostGraph, np.ndarray, int]] = []
        workers = max(1, int(ctx.parallel.num_workers))
        next_id = 0
        for b, span in enumerate(spans):
            if span.count > 1:
                sub = ext.subgraphs[b]
                max_w = bipartition_max_block_weights(
                    ctx, span.first, span.count, sub.total_node_weight
                )
                if sub.n >= ctx.partitioning.device_bipartition_threshold:
                    bp = self._device_bipartition(sub, max_w, rng)
                elif workers > 1:
                    # the seed of each pool job is drawn here, in block
                    # order, so that the result is the same for any number
                    # of workers
                    pool_jobs.append((len(sub_parts), sub, max_w,
                                      int(rng.integers(0, 2**31 - 1))))
                    bp = None
                else:
                    bp = bipartitioner.bipartition(sub, max_w, rng)
                k0, k1 = split_k(span.count)
                new_ids_base.append((next_id, next_id + 1))
                new_spans.append(_BlockSpan(span.first, k0))
                new_spans.append(_BlockSpan(span.first + k0, k1))
                sub_parts.append(bp)
                next_id += 2
            else:
                new_ids_base.append((next_id, -1))
                new_spans.append(span)
                sub_parts.append(None)
                next_id += 1

        def run_job(job):
            # a bipartitioner of its own: the pool's adaptive statistics
            # are not shared between threads
            idx, sub, max_w, job_seed = job
            return idx, InitialMultilevelBipartitioner(
                ctx.initial_partitioning
            ).bipartition(sub, max_w, np.random.default_rng(job_seed))

        if len(pool_jobs) > 1:
            # the native bipartitioner releases the interpreter lock for
            # its C call, so the threads run side by side
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for idx, bp in pool.map(run_job, pool_jobs):
                    sub_parts[idx] = bp
        else:
            for job in pool_jobs:
                idx, bp = run_job(job)
                sub_parts[idx] = bp

        new_part = np.zeros(host.n, dtype=np.int32)
        for b, span in enumerate(spans):
            mask = part == b
            id0, id1 = new_ids_base[b]
            if id1 < 0:
                new_part[mask] = id0
            else:
                bp = sub_parts[b]
                new_part[mask] = np.where(
                    bp[ext.node_mapping[mask]] == 0, id0, id1
                )
        self._spans = new_spans
        return (
            self._pad_partition(new_part, dgraph.n_pad), new_spans,
            len(new_spans),
        )
