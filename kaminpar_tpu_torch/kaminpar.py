"""Public API facade (counterpart of kaminpar_tpu/kaminpar.py): construct
with a preset or context and a device, set a graph, compute partitions.
Handles isolated-node removal and reintegration (kaminpar.cc:392-431) and
ends with the output gate's check-and-repair.

    part = KaMinPar("default", device="cuda").set_graph(g).compute_partition(
        k=16, epsilon=0.03, seed=1)

`copy_graph` takes raw CSR arrays; `set_initial_partition` warm-starts the
next v-cycle run from a given partition (one-shot); `set_output_level`
governs what this instance prints, only while it computes.  Each call
resets and fills the global timer and, when enabled, the telemetry stream
(run annotations, the output gate's verdict, the result), from which
`telemetry.report` builds the run report.

Schemes: deep multilevel, k-way, recursive bipartitioning, v-cycles and
the out-of-core `external` scheme on one device.  Inputs: a HostGraph, a
CompressedHostGraph (or a HostGraph under `ctx.compression.enabled`, the
`terapart*` presets, which `set_graph` compresses), and for the external
scheme a StreamedSpecGraph.  Compressed inputs stay compressed through
the deep and external schemes (chunked upload, chunked metrics); the
other schemes decode them once (`_decode_cached`).

Resilience, as in the JAX package: each call arms a deadline
(`ctx.resilience.time_budget`; `last_anytime` says where a wound-down run
stopped), a checkpoint manager (`checkpoint_dir`, `resume`) and the
memory governor (`memory_budget`), and runs the core partition under the
integrity retry ladder around the governor's OOM recovery ladder around
the `compressed-stream` fallback (resilience/).  Each call also resets
the statistics counters and the heap profiler (utils/; both record only
when enabled) and writes the debug dumps that `ctx.debug` asks for
(partitioning/debug.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import telemetry
from .context import Context, PartitioningMode
from .device import DeviceLike, resolve_device
from .external.chunkstore import (
    StreamedSpecGraph,
    streamed_partition_metrics,
)
from .graphs.compressed import (
    CompressedHostGraph,
    compress_host_graph,
    compressed_partition_metrics,
    extract_core_compressed,
)
from .graphs.host import (
    HostGraph,
    NodePermutation,
    count_isolated_nodes,
    host_partition_metrics,
    remove_isolated_nodes,
    validate as validate_graph,
)
from .partitioning import debug
from .presets import create_context_by_preset_name
from .resilience import checkpoint as ckpt_mod
from .resilience import deadline as deadline_mod
from .resilience import gate
from .resilience import integrity as integrity_mod
from .resilience import memory as mem_mod
from .resilience import supervisor as sup_mod
from .resilience.policy import with_fallback
from .utils import heap_profiler, statistics
from .utils import rng as rng_mod
from .utils import timer
from .utils.logger import (
    OutputLevel,
    log,
    log_warning,
    output_level,
    set_output_level,
)


class KaMinPar:
    """k-way graph partitioner with the reference's chained API, on one
    device (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    def __init__(self, ctx: Union[Context, str, None] = None,
                 device: DeviceLike = "cuda"):
        if ctx is None:
            ctx = create_context_by_preset_name("default")
        elif isinstance(ctx, str):
            ctx = create_context_by_preset_name(ctx)
        self.ctx = ctx
        self.device = resolve_device(device)
        self._graph: Optional[HostGraph] = None
        # wall seconds per phase of the last compute_partition call, and
        # the (n, m) of each level of its hierarchy, input first
        self.last_timings: Dict[str, float] = {}
        self.last_levels: List[Tuple[int, int]] = []
        # the output gate's verdict on the last compute_partition call
        self.last_gate: Optional[dict] = None
        # the external scheme's record of its last run (levels, chunks,
        # bytes, overlap), None after a run of another scheme
        self.last_external: Optional[dict] = None
        # where a run that wound down early (deadline, stop request,
        # signal) stopped; None after a run that did not
        self.last_anytime: Optional[dict] = None
        self._decoded = None
        self._core = None
        self._metrics_memo = None
        self.output_level = OutputLevel.APPLICATION
        self._explicit_level: Optional[OutputLevel] = None
        # the warm start of the next compute_partition call (v-cycle
        # scheme): a full-k partition and the cycle's coarsening depth;
        # one-shot, cleared when the call returns
        self._warm_part: Optional[np.ndarray] = None
        self._warm_levels: Optional[int] = None

    def set_graph(self, graph, validate: bool = False) -> "KaMinPar":
        """A HostGraph, a CompressedHostGraph or a StreamedSpecGraph.  With
        ``ctx.compression.enabled`` a HostGraph is stored compressed."""
        if isinstance(graph, (CompressedHostGraph, StreamedSpecGraph)):
            # their consumers stream (decode_range, chunk regeneration)
            self._graph = graph
        else:
            if validate:
                validate_graph(graph)
            if self.ctx.compression.enabled:
                graph = compress_host_graph(graph)
            self._graph = graph
        return self

    def copy_graph(
        self,
        xadj: Sequence[int],
        adjncy: Sequence[int],
        vwgt: Optional[Sequence[int]] = None,
        adjwgt: Optional[Sequence[int]] = None,
    ) -> "KaMinPar":
        """CSR ingestion (KaMinPar::copy_graph signature)."""
        self._graph = HostGraph(
            xadj=np.asarray(xadj),
            adjncy=np.asarray(adjncy, dtype=np.int32),
            node_weights=None if vwgt is None else np.asarray(vwgt),
            edge_weights=None if adjwgt is None else np.asarray(adjwgt),
        )
        return self

    def set_output_level(self, level: OutputLevel) -> "KaMinPar":
        """Instance-scoped: applied to the package's logger only while
        compute_partition runs; never called, the global level stands."""
        self.output_level = OutputLevel(level)
        self._explicit_level = self.output_level
        return self

    def set_initial_partition(
        self, partition, max_levels: Optional[int] = None
    ) -> "KaMinPar":
        """Warm-start the next ``compute_partition`` call (v-cycle scheme
        only): ``partition`` is a valid full-k labeling of the current
        graph, which the cycles refine in place of the initial deep run;
        ``max_levels`` bounds each cycle's restricted coarsening (0:
        refinement only).  One-shot: cleared when the call returns."""
        self._warm_part = (
            None if partition is None
            else np.asarray(partition, dtype=np.int32)
        )
        self._warm_levels = max_levels
        return self

    def graph(self):
        return self._graph

    def compute_partition(
        self,
        k: Optional[int] = None,
        epsilon: Optional[float] = None,
        max_block_weights: Optional[np.ndarray] = None,
        min_block_weights: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        if self._graph is None:
            raise RuntimeError("no graph set; call set_graph() first")
        graph = self._graph
        ctx = self.ctx
        if isinstance(graph, CompressedHostGraph) and self._must_decode():
            graph = self._decode_cached(graph)
        streaming_src = isinstance(graph, StreamedSpecGraph)
        if streaming_src and ctx.partitioning.mode != PartitioningMode.EXTERNAL:
            raise ValueError(
                "a generator-spec graph is partitioned by the external "
                "scheme only"
            )
        if seed is not None:
            ctx.seed = int(seed)
        rng_mod.set_seed(ctx.seed)
        ctx.partition.setup(
            graph, k=k, epsilon=epsilon, max_block_weights=max_block_weights
        )
        if min_block_weights is not None:
            ctx.partition.min_block_weights = np.asarray(
                min_block_weights, dtype=np.int64
            )
        self._validate_parameters()
        self.last_timings = {}
        self.last_levels = []
        self.last_external = None

        timer.GLOBAL_TIMER.reset()
        heap_profiler.reset()
        statistics.reset()
        # a run nested in another (an open timer scope) leaves the outer
        # run's telemetry stream alone
        owns_stream = timer.GLOBAL_TIMER.idle()
        if owns_stream:
            telemetry.reset()
            telemetry.annotate(
                preset=ctx.preset_name,
                seed=int(ctx.seed),
                k=int(ctx.partition.k),
                epsilon=float(ctx.partition.epsilon),
                mode=ctx.partitioning.mode.value,
                graph={"n": int(graph.n), "m": int(graph.m)},
            )
        # the run that owns the stream arms the deadline, the checkpoint
        # manager and the memory governor; a nested run leaves the outer
        # run's state alone (its barriers are blinded)
        mgr = None
        res_ctx = ctx.resilience
        self.last_anytime = None
        # the hard wall-clock watchdog (resilience/supervisor.py): when a
        # ceiling resolves (the environment's, or the factor times a
        # budget) the partitioning block runs under an armed stage that
        # turns an overrun into a StageHang; None arms nothing
        hard_ceiling_s = None
        if owns_stream:
            ckpt_mod.deactivate()
            deadline_mod.begin_run(res_ctx.time_budget or None,
                                   res_ctx.budget_grace,
                                   res_ctx.hard_deadline_factor)
            mgr = ckpt_mod.create_manager(res_ctx, self._graph, ctx)
            if mgr is not None:
                ckpt_mod.activate(mgr)
            # the governor prices the whole graph
            mem_mod.begin_run(graph, ctx, self.device)
            hard_ceiling_s = sup_mod.hard_ceiling(
                res_ctx.time_budget, res_ctx.budget_grace,
                res_ctx.hard_deadline_factor)
        else:
            ckpt_mod.suspend()
        debug.dump_toplevel_graph(ctx, graph)
        # the logger is process-global; this instance's level holds only
        # while it computes
        prior_level = output_level()
        try:
            set_output_level(prior_level if self._explicit_level is None
                             else self._explicit_level)
            if self.output_level >= OutputLevel.APPLICATION:
                self._print_context_summary(graph, ctx)
            with sup_mod.stage_guard("partition", hard_ceiling_s), \
                    timer.scoped_timer("partitioning"), \
                    heap_profiler.scoped_heap_profiler("partitioning"):
                resumed = (mgr.take_result_resume() if mgr is not None
                           else None)
                if resumed is not None and resumed.shape == (graph.n,):
                    # preempted after the output gate: nothing to compute
                    partition = resumed
                else:
                    partition = self._partition_with_isolated(
                        graph, streaming_src)
        finally:
            set_output_level(prior_level)
            self._warm_part = None
            self._warm_levels = None
            if not owns_stream:
                ckpt_mod.unsuspend()

        if ctx.resilience.output_gate:
            with timer.scoped_timer("output-gate"):
                reported = self.result_metrics(graph, partition)["cut"]
                partition, self.last_gate = gate.check_and_repair(
                    graph, partition, ctx.partition,
                    repair=ctx.resilience.repair, reported_cut=reported,
                )
            if owns_stream:
                telemetry.annotate(output_gate=self.last_gate)
        if owns_stream:
            self._finish_resilience(mgr, partition)
        debug.dump_toplevel_partition(ctx, partition)
        if self.output_level >= OutputLevel.APPLICATION or (
            telemetry.enabled() and timer.GLOBAL_TIMER.idle()
        ):
            self._print_result(graph, partition)
        return partition

    def _finish_resilience(self, mgr, partition) -> None:
        """The final `result` barrier (a preemption after the gate resumes
        at once), then the run report's anytime, checkpoint and
        memory-budget sections; releases the run's checkpoint manager."""
        if mgr is not None and mgr.enabled:
            ckpt_mod.barrier(
                "result", scheme="facade",
                payload=lambda: {"state": {
                    "partition": np.asarray(partition, dtype=np.int32),
                }},
            )
        if deadline_mod.triggered():
            self.last_anytime = deadline_mod.state()
            telemetry.annotate(anytime=self.last_anytime)
            log_warning(
                "ANYTIME result: wound down at stage "
                f"'{self.last_anytime.get('stage') or 'start'}' "
                f"({self.last_anytime.get('reason')}); partition is "
                "gate-validated but lower-effort"
            )
        if mgr is not None:
            telemetry.annotate(checkpoint=mgr.summary())
        mem_summary = mem_mod.summary()
        if mem_summary.get("enabled"):
            telemetry.annotate(memory_budget=mem_summary)
        ckpt_mod.deactivate()

    def _partition_with_isolated(self, graph, streaming_src: bool):
        """Isolated-node preprocessing (kaminpar.cc:392-404) around the
        scheme: the core is partitioned, isolated nodes refill blocks by
        headroom."""
        ctx = self.ctx
        if (self._warm_part is not None
                and self._warm_part.shape != (graph.n,)):
            # checked before the core permutation, which would index it
            raise ValueError(f"warm-start partition shape "
                             f"{self._warm_part.shape} != ({graph.n},)")
        num_isolated = count_isolated_nodes(graph)
        if (num_isolated and graph.n > num_isolated
                and isinstance(graph, CompressedHostGraph)):
            # the core is extracted compressed to compressed (chunked
            # re-encode, kept for the next call on this graph); isolated
            # nodes refill blocks by headroom
            if self._core is None or self._core[0] is not graph:
                self._core = (graph, extract_core_compressed(graph))
            core_cg, core_ids, iso_ids = self._core[1]
            part_core = self._partition_core_governed(core_cg)
            new_to_old = np.concatenate([core_ids, iso_ids])
            old_to_new = np.empty(graph.n, dtype=np.int64)
            old_to_new[new_to_old] = np.arange(graph.n)
            return self._reintegrate_isolated(
                graph, core_cg, NodePermutation(old_to_new, new_to_old),
                part_core,
            )
        if num_isolated and graph.n > num_isolated and not streaming_src:
            # a generator-spec graph keeps its isolated nodes in the
            # stream: the external scheme places them
            core, perm, _ = remove_isolated_nodes(graph)
            if self._warm_part is not None:
                # the warm start follows the core permutation: the first
                # core.n permuted nodes are the ones the core run sees
                self._warm_part = self._warm_part[perm.new_to_old[: core.n]]
            part_core = self._partition_core_governed(core)
            return self._reintegrate_isolated(graph, core, perm, part_core)
        if num_isolated == graph.n and graph.n > 0:
            return _fill_blocks_by_headroom(
                graph.node_weight_array(),
                np.zeros(ctx.partition.k, dtype=np.int64),
                ctx.partition.max_block_weights,
            )
        return self._partition_core_governed(graph)

    def _partition_core_governed(self, graph) -> np.ndarray:
        """The core partition under the integrity retry ladder (one
        re-execution from the last clean barrier after a sentinel fired)
        around the memory governor's OOM ladder."""
        ctx = self.ctx
        return integrity_mod.run_with_retry(
            lambda: mem_mod.run_ladder(
                lambda: self._partition_core_resilient(graph),
                graph, ctx, facade=self,
            ),
            where="partition-core",
        )

    def _partition_core_resilient(self, graph) -> np.ndarray:
        """The scheme under the `compressed-stream` contract: when the
        chunked upload of a compressed graph fails (device OOM, an
        injected fault), the graph is decoded (once, `_decode_cached`) and
        the plain CSR partitioned."""
        if not isinstance(graph, CompressedHostGraph):
            return self._partition_core(graph)
        return with_fallback(
            lambda: self._partition_core(graph),
            lambda exc: self._partition_core(self._decode_cached(graph)),
            site="compressed-stream",
        )

    def _partition_core(self, graph: HostGraph) -> np.ndarray:
        """Scheme dispatch (factories.cc:40-57 create_partitioner)."""
        mode = self.ctx.partitioning.mode
        if mode == PartitioningMode.EXTERNAL:
            from .external.driver import ExternalPartitioner as cls
        elif mode == PartitioningMode.DEEP:
            from .partitioning.deep import DeepMultilevelPartitioner as cls
        elif mode == PartitioningMode.KWAY:
            from .partitioning.kway import KWayMultilevelPartitioner as cls
        elif mode == PartitioningMode.RB:
            from .partitioning.rb_scheme import RBMultilevelPartitioner as cls
        elif mode == PartitioningMode.VCYCLE:
            from .partitioning.vcycle import (
                VcycleDeepMultilevelPartitioner as cls,
            )
        else:
            raise ValueError(f"unknown partitioning mode: {mode}")
        if mode == PartitioningMode.VCYCLE:
            partitioner = cls(self.ctx, self.device,
                              initial_partition=self._warm_part,
                              max_levels=self._warm_levels)
        else:
            partitioner = cls(self.ctx, self.device)
        part = partitioner.partition(graph)
        self.last_timings = dict(partitioner.timings)
        self.last_levels = list(partitioner.levels)
        if mode == PartitioningMode.EXTERNAL:
            self.last_external = partitioner.section
        return part

    def _must_decode(self) -> bool:
        """Whether a compressed input needs the full host CSR: the debug
        dumps of the input graph and of every level write host rows, and
        so does every scheme but the deep one (chunked upload) and the
        external one (chunked stream)."""
        d = self.ctx.debug
        if (d.dump_toplevel_graph or d.dump_toplevel_partition
                or d.dump_graph_hierarchy):
            return True
        return self.ctx.partitioning.mode not in (
            PartitioningMode.DEEP, PartitioningMode.EXTERNAL,
        )

    def _decode_cached(self, cgraph):
        """The full decode of a compressed input, kept for repeated
        compute_partition calls (seed and k sweeps) and shared by the
        non-deep schemes and the `compressed-stream` fallback."""
        if self._decoded is None or self._decoded[0] is not cgraph:
            self._decoded = (cgraph, cgraph.decode())
        return self._decoded[1]

    def result_metrics(self, graph, partition) -> dict:
        """cut, imbalance and feasibility of a partition; compressed and
        generator-spec graphs are swept chunk by chunk.  Kept for the last
        (graph, partition) pair: the gate and the RESULT line ask for the
        same numbers."""
        memo = self._metrics_memo
        if memo is not None and memo[0] is graph and memo[1] is partition:
            return memo[2]
        p = self.ctx.partition
        if isinstance(graph, CompressedHostGraph):
            m = compressed_partition_metrics(graph, partition, p.k)
        elif isinstance(graph, StreamedSpecGraph):
            m = streamed_partition_metrics(graph, partition, p.k)
        else:
            m = host_partition_metrics(graph, partition, p.k)
        result = {
            "cut": int(m["cut"]),
            "imbalance": float(m["imbalance"]),
            "feasible": bool(
                (m["block_weights"] <= p.max_block_weights).all()
            ),
        }
        self._metrics_memo = (graph, partition, result)
        return result

    def _validate_parameters(self) -> None:
        p = self.ctx.partition
        if p.k < 1:
            raise ValueError("k must be >= 1")
        if int(p.max_block_weights.sum()) < p.total_node_weight:
            raise ValueError(
                "infeasible: total max block weight "
                f"{int(p.max_block_weights.sum())} < total node weight "
                f"{p.total_node_weight}"
            )

    def _reintegrate_isolated(self, graph, core, perm, part_core) -> np.ndarray:
        """kaminpar.cc:422-431: isolated nodes fill up underloaded blocks."""
        p = self.ctx.partition
        partition = np.zeros(graph.n, dtype=np.int32)
        core_n = core.n
        partition_permuted = np.zeros(graph.n, dtype=np.int32)
        partition_permuted[:core_n] = part_core
        node_w = graph.node_weight_array()[perm.new_to_old]
        bw = np.zeros(p.k, dtype=np.int64)
        np.add.at(bw, part_core, node_w[:core_n].astype(np.int64))
        partition_permuted[core_n:] = _fill_blocks_by_headroom(
            node_w[core_n:], bw, p.max_block_weights
        )
        partition[perm.new_to_old] = partition_permuted
        return partition

    def _print_context_summary(self, graph, ctx: Context) -> None:
        """Startup banner and compact context block (the reference's
        version banner and context printer)."""
        from . import __version__

        p = ctx.partition
        log(f"kaminpar-tpu-torch v{__version__} (preset "
            f"'{ctx.preset_name}', seed {ctx.seed}, device {self.device})")
        log(f"  graph: n={graph.n} m={graph.m} "
            f"total_node_weight={graph.total_node_weight}")
        log(f"  partition: k={p.k} eps={p.epsilon} "
            f"mode={ctx.partitioning.mode.value}")
        log(f"  coarsening: {ctx.coarsening.algorithm.value} "
            f"(contraction limit {ctx.coarsening.contraction_limit}), "
            f"refinement: "
            f"{';'.join(a.value for a in ctx.refinement.algorithms)}")

    def _print_result(self, graph, partition) -> None:
        """Parseable RESULT line (kaminpar-shm/kaminpar.cc:48) and the
        run report's `result` annotation."""
        m = self.result_metrics(graph, partition)
        if timer.GLOBAL_TIMER.idle():  # nested runs don't own the stream
            telemetry.annotate(result=m)
        if self.output_level >= OutputLevel.APPLICATION:
            log(
                f"RESULT cut={m['cut']} imbalance={m['imbalance']:.6f} "
                f"feasible={int(m['feasible'])} k={self.ctx.partition.k}"
            )


def _fill_blocks_by_headroom(
    node_w: np.ndarray, block_w: np.ndarray, max_block_weights: np.ndarray
) -> np.ndarray:
    """Assign edge-less nodes to blocks without exceeding the caps: fill
    blocks in descending-headroom order with node prefixes by cumulative
    weight."""
    n = len(node_w)
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    headroom = (np.asarray(max_block_weights, dtype=np.int64) - block_w).clip(0)
    order = np.argsort(-headroom, kind="stable")
    cum = np.cumsum(node_w.astype(np.int64))
    start = 0
    assigned = 0
    for b in order:
        if start >= n:
            break
        end = int(np.searchsorted(cum, assigned + headroom[b], side="right"))
        out[start:end] = b
        if end > start:
            assigned = int(cum[end - 1])
        start = end
    if start < n:
        out[start:] = int(order[0])
    return out


def context_from_preset(name: str) -> Context:
    return create_context_by_preset_name(name)
