"""Public API facade (counterpart of kaminpar_tpu/kaminpar.py): construct
with a preset or context and a device, set a graph, compute partitions.
Handles isolated-node removal and reintegration (kaminpar.cc:392-431) and
ends with the output gate's check-and-repair.

    part = KaMinPar("default", device="cuda").set_graph(g).compute_partition(
        k=16, epsilon=0.03, seed=1)

Schemes: deep multilevel, k-way, recursive bipartitioning, v-cycles and
the out-of-core `external` scheme on one device.  Inputs: a HostGraph, a
CompressedHostGraph (or a HostGraph under `ctx.compression.enabled`, the
`terapart*` presets, which `set_graph` compresses), and for the external
scheme a StreamedSpecGraph.  Compressed inputs stay compressed through
the deep and external schemes (chunked upload, chunked metrics); the
other schemes decode them once.  The JAX package's deadlines,
checkpoints, memory governor and telemetry are not part of this package:
a declared memory budget acts only on the external scheme.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

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
from .presets import create_context_by_preset_name
from .resilience import gate


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
        self._decoded = None

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

        num_isolated = count_isolated_nodes(graph)
        if (num_isolated and graph.n > num_isolated
                and isinstance(graph, CompressedHostGraph)):
            # the core is extracted compressed to compressed (chunked
            # re-encode); isolated nodes refill blocks by headroom
            core_cg, core_ids, iso_ids = extract_core_compressed(graph)
            part_core = self._partition_core(core_cg)
            new_to_old = np.concatenate([core_ids, iso_ids])
            old_to_new = np.empty(graph.n, dtype=np.int64)
            old_to_new[new_to_old] = np.arange(graph.n)
            partition = self._reintegrate_isolated(
                graph, core_cg, NodePermutation(old_to_new, new_to_old),
                part_core,
            )
        elif num_isolated and graph.n > num_isolated and not streaming_src:
            # a generator-spec graph keeps its isolated nodes in the
            # stream: the external scheme places them
            core, perm, _ = remove_isolated_nodes(graph)
            part_core = self._partition_core(core)
            partition = self._reintegrate_isolated(graph, core, perm,
                                                   part_core)
        elif num_isolated == graph.n and graph.n > 0:
            partition = _fill_blocks_by_headroom(
                graph.node_weight_array(),
                np.zeros(ctx.partition.k, dtype=np.int64),
                ctx.partition.max_block_weights,
            )
        else:
            partition = self._partition_core(graph)

        if ctx.resilience.output_gate:
            reported = self.result_metrics(graph, partition)["cut"]
            partition, self.last_gate = gate.check_and_repair(
                graph, partition, ctx.partition,
                repair=ctx.resilience.repair, reported_cut=reported,
            )
        return partition

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
        partitioner = cls(self.ctx, self.device)
        part = partitioner.partition(graph)
        self.last_timings = dict(partitioner.timings)
        self.last_levels = list(partitioner.levels)
        if mode == PartitioningMode.EXTERNAL:
            self.last_external = partitioner.section
        return part

    def _must_decode(self) -> bool:
        """Whether a compressed input needs the full host CSR: every scheme
        but the deep one (chunked upload) and the external one (chunked
        stream) reads host rows."""
        return self.ctx.partitioning.mode not in (
            PartitioningMode.DEEP, PartitioningMode.EXTERNAL,
        )

    def _decode_cached(self, cgraph):
        """The full decode of a compressed input, kept for repeated
        compute_partition calls on it."""
        if self._decoded is None or self._decoded[0] is not cgraph:
            self._decoded = (cgraph, cgraph.decode())
        return self._decoded[1]

    def result_metrics(self, graph, partition) -> dict:
        """cut, imbalance and feasibility of a partition; compressed and
        generator-spec graphs are swept chunk by chunk."""
        p = self.ctx.partition
        if isinstance(graph, CompressedHostGraph):
            m = compressed_partition_metrics(graph, partition, p.k)
        elif isinstance(graph, StreamedSpecGraph):
            m = streamed_partition_metrics(graph, partition, p.k)
        else:
            m = host_partition_metrics(graph, partition, p.k)
        return {
            "cut": int(m["cut"]),
            "imbalance": float(m["imbalance"]),
            "feasible": bool(
                (m["block_weights"] <= p.max_block_weights).all()
            ),
        }

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
