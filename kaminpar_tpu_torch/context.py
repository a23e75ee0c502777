"""Configuration tree (analog of include/kaminpar-shm/kaminpar.h Context).

Own copy of kaminpar_tpu/context.py (numpy only), field for field: the
knobs that the JAX package accepts for parity with the reference and
reads nowhere are here too, so that both trees give the same dict, TOML
dump and checkpoint fingerprint.

The reference models every algorithmic choice as an enum + plain-struct tree
(Context -> PartitioningContext/CoarseningContext/InitialPartitioningContext/
RefinementContext, include/kaminpar-shm/kaminpar.h:94-562).  We mirror that
with dataclasses; presets.py builds filled-in trees by name.

PartitionContext reproduces the block-weight semantics of
include/kaminpar-shm/kaminpar.h:371-478: max block weights derived from
(1+eps)*ceil(total/k), optional relaxation by the max node weight, inferred
epsilon for custom weight vectors, optional min block weights.
"""

from __future__ import annotations

import enum
import math as pymath
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class PartitioningMode(str, enum.Enum):
    """include/kaminpar-shm/kaminpar.h:94-98 (+ the out-of-core
    streaming scheme of the JAX package)."""

    DEEP = "deep"
    RB = "rb"
    KWAY = "kway"
    VCYCLE = "vcycle"
    EXTERNAL = "external"


class ClusteringAlgorithm(str, enum.Enum):
    NOOP = "noop"
    LABEL_PROPAGATION = "lp"


class CoarseningAlgorithm(str, enum.Enum):
    NOOP = "noop"
    BASIC_CLUSTERING = "basic"
    OVERLAY_CLUSTERING = "overlay"
    SPARSIFICATION_CLUSTERING = "sparsification"


class ClusterWeightLimit(str, enum.Enum):
    """max_cluster_weights.h ClusterWeightLimit."""

    EPSILON_BLOCK_WEIGHT = "epsilon-block-weight"
    BLOCK_WEIGHT = "static-block-weight"
    ONE = "one"
    ZERO = "zero"


class RefinementAlgorithm(str, enum.Enum):
    NOOP = "noop"
    LABEL_PROPAGATION = "lp"
    OVERLOAD_BALANCER = "overload-balancer"
    UNDERLOAD_BALANCER = "underload-balancer"
    JET = "jet"
    GREEDY_FM = "fm"
    MTKAHYPAR = "mtkahypar"


class TwoHopStrategy(str, enum.Enum):
    DISABLE = "disable"
    CLUSTER = "cluster"
    MATCH = "match"


class IsolatedNodesStrategy(str, enum.Enum):
    KEEP = "keep"
    CLUSTER = "cluster"
    MATCH_DURING_TWO_HOP = "cluster-during-two-hop"


class InitialPartitioningMode(str, enum.Enum):
    SEQUENTIAL = "sequential"
    ASYNCHRONOUS_PARALLEL = "async-parallel"
    SYNCHRONOUS_PARALLEL = "sync-parallel"


class FMStoppingRule(str, enum.Enum):
    SIMPLE = "simple"
    ADAPTIVE = "adaptive"


@dataclass
class LabelPropagationContext:
    """kaminpar.h LabelPropagationCoarseningContext (+ bulk-sync knobs)."""

    num_iterations: int = 5
    # degree-skew knobs of the reference (label_propagation.h:1939),
    # accepted for context parity; no device path reads them
    large_degree_threshold: int = 2**31 - 1
    max_num_neighbors: int = 2**31 - 1
    two_hop_strategy: TwoHopStrategy = TwoHopStrategy.CLUSTER
    two_hop_threshold: float = 0.5
    isolated_nodes_strategy: IsolatedNodesStrategy = (
        IsolatedNodesStrategy.MATCH_DURING_TWO_HOP
    )
    # bulk-synchronous device LP specifics (no reference analog; see ops/lp.py)
    participation: float = 0.5
    allow_tie_moves: bool = True
    use_active_set: bool = True
    # rating engine (ops/rating.py): "auto" = per-level density-adaptive
    # selection (dense / scatter / sort2); "scatter"/"sort2"/"sort"/
    # "hash"/"dense" force one for comparison runs (--lp-rating)
    rating: str = "auto"
    # hashed slots per node row for the scatter/hash engines
    rating_slots: int = 32


@dataclass
class ClusteringContext:
    algorithm: ClusteringAlgorithm = ClusteringAlgorithm.LABEL_PROPAGATION
    lp: LabelPropagationContext = field(default_factory=LabelPropagationContext)
    cluster_weight_limit: ClusterWeightLimit = (
        ClusterWeightLimit.EPSILON_BLOCK_WEIGHT
    )
    cluster_weight_multiplier: float = 1.0
    # desired-cluster-count floor (n / shrink_factor); accepted for preset
    # parity, not enforced by the bulk-sync clusterer (as in the JAX package)
    shrink_factor: float = float("inf")
    # terapart-largek: force an extra coarsening level at the
    # k-contraction boundary (presets.cc create_terapart_largek_context);
    # set for preset parity, read by neither package
    forced_kc_level: bool = False
    # overlay coarsening (OverlayClusterCoarsener): number of independent
    # clusterings intersected per level
    num_overlays: int = 2


@dataclass
class CoarseningContext:
    """kaminpar.h CoarseningContext (presets.cc:178-179 defaults)."""

    algorithm: CoarseningAlgorithm = CoarseningAlgorithm.BASIC_CLUSTERING
    clustering: ClusteringContext = field(default_factory=ClusteringContext)
    contraction_limit: int = 2000
    convergence_threshold: float = 0.05
    # TPU-specific limping-tail cutoff: once n <= 8 * contraction_limit,
    # a level shrinking less than this fraction ends coarsening (every
    # accepted level costs a full refine pass during uncoarsening; the
    # host IP pool handles a 10-16k-node coarsest graph directly)
    stall_threshold: float = 0.12
    # linear-time MGP (arXiv 2504.17615): fraction of edges kept per level
    # before clustering, under SPARSIFICATION_CLUSTERING
    sparsification_keep_ratio: float = 0.5

    def max_cluster_weight(
        self, n: int, total_node_weight: int, p_ctx: "PartitionContext"
    ) -> int:
        """compute_max_cluster_weight (max_cluster_weights.h)."""
        limit = self.clustering.cluster_weight_limit
        if limit == ClusterWeightLimit.EPSILON_BLOCK_WEIGHT:
            divisor = min(max(n // max(self.contraction_limit, 1), 2), p_ctx.k)
            w = (
                p_ctx.infer_epsilon(total_node_weight) * total_node_weight
            ) / divisor
        elif limit == ClusterWeightLimit.BLOCK_WEIGHT:
            w = (1.0 + p_ctx.inferred_epsilon()) * total_node_weight / p_ctx.k
        elif limit == ClusterWeightLimit.ONE:
            w = 1.0
        else:
            w = 0.0
        return int(w * self.clustering.cluster_weight_multiplier)


@dataclass
class InitialCoarseningContext:
    """presets.cc:185-189 defaults."""

    contraction_limit: int = 20
    convergence_threshold: float = 0.05
    large_degree_threshold: int = 1_000_000
    cluster_weight_limit: ClusterWeightLimit = ClusterWeightLimit.BLOCK_WEIGHT
    cluster_weight_multiplier: float = 1.0 / 12.0


@dataclass
class InitialRefinementContext:
    """Sequential 2-way FM knobs (presets.cc:196-201)."""

    disabled: bool = False
    stopping_rule: FMStoppingRule = FMStoppingRule.SIMPLE
    num_fruitless_moves: int = 100
    alpha: float = 1.0
    num_iterations: int = 5
    improvement_abortion_threshold: float = 0.0001


@dataclass
class InitialPoolContext:
    """presets.cc:202-211 defaults."""

    refinement: InitialRefinementContext = field(
        default_factory=InitialRefinementContext
    )
    repetition_multiplier: float = 1.0
    min_num_repetitions: int = 10
    min_num_non_adaptive_repetitions: int = 5
    max_num_repetitions: int = 50
    use_adaptive_bipartitioner_selection: bool = True
    enable_bfs_bipartitioner: bool = True
    enable_ggg_bipartitioner: bool = True
    enable_random_bipartitioner: bool = True


@dataclass
class InitialPartitioningContext:
    coarsening: InitialCoarseningContext = field(
        default_factory=InitialCoarseningContext
    )
    pool: InitialPoolContext = field(default_factory=InitialPoolContext)
    refinement: InitialRefinementContext = field(
        default_factory=InitialRefinementContext
    )
    use_adaptive_epsilon: bool = True


@dataclass
class LPRefinementContext:
    num_iterations: int = 5
    participation: float = 0.8


@dataclass
class JetRefinementContext:
    """presets.cc jet defaults (num_iterations=0 means auto by level)."""

    num_iterations: int = 0
    num_fruitless_iterations: int = 12
    fruitless_threshold: float = 0.999
    num_rounds_on_fine_level: int = 1
    num_rounds_on_coarse_level: int = 1
    initial_gain_temp_on_fine_level: float = 0.25
    final_gain_temp_on_fine_level: float = 0.25
    initial_gain_temp_on_coarse_level: float = 0.75
    final_gain_temp_on_coarse_level: float = 0.75


@dataclass
class BalancerContext:
    max_rounds: int = 8


@dataclass
class FMRefinementContext:
    """Host-side k-way FM (refinement/fm) knobs."""

    num_iterations: int = 3
    num_seed_nodes: int = 10
    alpha: float = 1.0
    num_fruitless_moves: int = 100
    # run FM only on levels <= max_level (0 = finest)
    max_level: int = 1


@dataclass
class RefinementContext:
    algorithms: List[RefinementAlgorithm] = field(
        default_factory=lambda: [
            RefinementAlgorithm.OVERLOAD_BALANCER,
            RefinementAlgorithm.LABEL_PROPAGATION,
            RefinementAlgorithm.UNDERLOAD_BALANCER,
        ]
    )
    lp: LPRefinementContext = field(default_factory=LPRefinementContext)
    jet: JetRefinementContext = field(default_factory=JetRefinementContext)
    balancer: BalancerContext = field(default_factory=BalancerContext)
    fm: FMRefinementContext = field(default_factory=FMRefinementContext)

    def includes_algorithm(self, algorithm: RefinementAlgorithm) -> bool:
        return algorithm in self.algorithms


@dataclass
class PartitioningSchemeContext:
    """kaminpar.h PartitioningContext."""

    mode: PartitioningMode = PartitioningMode.DEEP
    deep_initial_partitioning_mode: InitialPartitioningMode = (
        InitialPartitioningMode.ASYNCHRONOUS_PARALLEL
    )
    deep_initial_partitioning_load: float = 1.0
    refine_after_extending_partition: bool = False
    # single-round Jet for intermediate k-doubling extensions (another
    # doubling follows immediately): ~13% faster end-to-end for ~0.1%
    # cut on the RMAT bench — on for the fast preset, off by default
    light_intermediate_refinement: bool = False
    # extend_partition blocks at least this large are bipartitioned through
    # the device pipeline (LP coarsening + 2-way device refinement) instead
    # of the sequential host pool — the TPU answer to the reference running
    # many host bipartitions in parallel TBB tasks (helper.cc:220)
    device_bipartition_threshold: int = 1 << 14
    vcycles: List[int] = field(default_factory=list)
    restrict_vcycle_refinement: bool = False
    rb_enable_kway_toplevel_refinement: bool = False


@dataclass
class ParallelContext:
    # host worker threads for the per-block bipartitions of a host
    # extension and for the native FM
    num_workers: int = 1


@dataclass
class PartitionContext:
    """Block count and weight constraints
    (include/kaminpar-shm/kaminpar.h:371-478)."""

    k: int = 2
    epsilon: float = 0.03
    n: int = 0
    m: int = 0
    total_node_weight: int = 0
    total_edge_weight: int = 0
    max_node_weight: int = 0
    max_block_weights: Optional[np.ndarray] = None  # relaxed
    unrelaxed_max_block_weights: Optional[np.ndarray] = None
    min_block_weights: Optional[np.ndarray] = None
    uniform_block_weights: bool = True

    def setup(self, graph, k: Optional[int] = None, epsilon: Optional[float] = None,
              max_block_weights: Optional[np.ndarray] = None,
              relax_max_block_weights: bool = True) -> None:
        """PartitionContext::setup (context.cc:27-70)."""
        if k is not None:
            self.k = int(k)
        if epsilon is not None:
            self.epsilon = float(epsilon)
        self.n = graph.n
        self.m = graph.m
        self.total_node_weight = graph.total_node_weight
        self.total_edge_weight = graph.total_edge_weight
        nw = graph.node_weight_array()
        self.max_node_weight = int(nw.max()) if len(nw) else 0

        if max_block_weights is None:
            perfect = pymath.ceil(self.total_node_weight / self.k)
            max_block_weights = np.full(
                self.k, int((1.0 + self.epsilon) * perfect), dtype=np.int64
            )
            self.uniform_block_weights = True
        else:
            max_block_weights = np.asarray(max_block_weights, dtype=np.int64)
            self.k = len(max_block_weights)
            self.uniform_block_weights = False
        self.unrelaxed_max_block_weights = max_block_weights.copy()

        if relax_max_block_weights:
            eps = self.inferred_epsilon()
            relaxed = np.maximum(
                max_block_weights,
                np.ceil(max_block_weights / (1.0 + eps)).astype(np.int64)
                + self.max_node_weight,
            )
            self.max_block_weights = relaxed
        else:
            self.max_block_weights = max_block_weights

    def infer_epsilon(self, actual_total_node_weight: int) -> float:
        """kaminpar.h:427-433."""
        if self.unrelaxed_max_block_weights is None:
            return self.epsilon
        total_max = int(self.unrelaxed_max_block_weights.sum())
        if actual_total_node_weight <= 0:
            return self.epsilon
        return max(total_max / actual_total_node_weight - 1.0, 0.0)

    def inferred_epsilon(self) -> float:
        return self.infer_epsilon(self.total_node_weight)

    def perfectly_balanced_block_weight(self, block: int = 0) -> int:
        if self.unrelaxed_max_block_weights is None:
            return pymath.ceil(self.total_node_weight / self.k)
        return pymath.ceil(
            self.unrelaxed_max_block_weights[block] / (1.0 + self.inferred_epsilon())
        )

    def setup_min_block_weights(self, min_epsilon: float) -> None:
        """context.cc:72-81."""
        self.min_block_weights = np.array(
            [
                pymath.ceil(
                    (1.0 - min_epsilon) * self.perfectly_balanced_block_weight(b)
                )
                for b in range(self.k)
            ],
            dtype=np.int64,
        )

    def total_max_block_weights(self, begin: int, end: int) -> int:
        """kaminpar.h:398-408 (sum of unrelaxed max weights in [begin, end))."""
        return int(self.unrelaxed_max_block_weights[begin:end].sum())

    def max_block_weight(self, block: int = 0) -> int:
        return int(self.max_block_weights[block])


@dataclass
class GraphCompressionContext:
    """Compressed-graph (TeraPart) mode: `set_graph` stores the host graph
    compressed (graphs/compressed.py) and the deep scheme uploads it chunk
    by chunk; the device path is unchanged."""

    enabled: bool = False


@dataclass
class ResilienceContext:
    """Degradation and output-gate policy (resilience/).

    `output_gate` runs the end-of-pipeline strict-balance validator,
    `repair` lets it fix balance violations with the greedy host pass.
    `checkpoint_dir` enables atomic barrier snapshots there; `resume`
    re-enters at the recorded stage when the directory holds a matching
    manifest; `time_budget` (> 0, seconds) arms a monotonic deadline
    checked at the pipeline barriers, after which the run winds down to a
    gate-valid partition annotated `anytime: true`; `budget_grace` is the
    declared wind-down allowance on top of it (reported, not enforced).
    `hard_deadline_factor` arms the hard wall-clock watchdog of a
    budgeted run at max(factor * budget, budget + grace) seconds
    (resilience/supervisor.py; 0 arms nothing).
    `memory_budget` is a declared device-memory budget in bytes (0 = take
    KAMINPAR_TPU_HBM_BYTES, unset = none), which the memory governor
    enforces (resilience/memory.py) and the external scheme sizes its
    chunks and stream depth against."""

    output_gate: bool = True
    repair: bool = True
    checkpoint_dir: str = ""
    resume: bool = False
    time_budget: float = 0.0
    budget_grace: float = 30.0
    hard_deadline_factor: float = 10.0
    memory_budget: float = 0.0


@dataclass
class ExternalContext:
    """Out-of-core streaming scheme (external/): the fine graph stays in
    host RAM (compressed chunks, plain CSR or a generator spec that
    regenerates chunks on demand) or on disk, and LP rating and
    contraction stream over fixed-shape padded edge-block chunks on the
    device — only coarse levels are ever device-resident."""

    #: Target edges per streamed chunk (every chunk of a level shares one
    #: padded edge-block size: the largest chunk's).
    chunk_edges: int = 1 << 22
    #: Streaming LP rounds per level (bulk-synchronous: moves are rated
    #: against the round-start labels and applied once per round, which
    #: makes the result independent of the chunk count).
    lp_rounds: int = 3
    #: Stream at least this many levels before the in-core handoff even
    #: without a memory budget (with one, streaming continues until the
    #: coarse level's estimate fits it).
    min_stream_levels: int = 1
    #: Cap on streamed levels (stall safety).
    max_stream_levels: int = 32
    #: Disk spill tier: when set, the level-0 chunks are written here once
    #: and re-read on every later pass instead of decoded or regenerated.
    spill_dir: str = ""


@dataclass
class DynamicContext:
    """Dynamic repartitioning policy (dynamic/): a graph that mutates
    between requests gets a warm-started v-cycle over its previous
    partition instead of a cold run.  The drift estimate (delta edge mass
    touching the cut over the total edge mass, plus the balance violation
    after the patch) picks warm or cold; replicas race the warm run
    against cold ones and keep the better cut.  Part of the ctx
    fingerprint: these knobs change the partition."""

    #: drift above this runs a cold repartition instead of the warm one
    drift_threshold: float = 0.25
    #: 1 = the drift decision alone; G >= 2 races the warm v-cycle
    #: against G - 1 cold replicas (seeds varied) and keeps the best
    #: feasible cut
    replicas: int = 1
    #: restricted-coarsening depth of the warm v-cycle (0: refinement of
    #: the previous partition at the fine level only)
    warm_levels: int = 0
    #: the telemetry.diff cut gate across a delta: a warm cut more than
    #: this fraction above the pre-delta cut escalates to a cold run
    cut_gate_threshold: float = 0.10
    #: whether a warm result the gate rejects may escalate at all
    cold_fallback: bool = True


@dataclass
class DebugContext:
    """kaminpar.h:484-496: hierarchy dumps (partitioning/debug.py)."""

    graph_name: str = ""
    dump_toplevel_graph: bool = False
    dump_toplevel_partition: bool = False
    dump_coarsest_graph: bool = False
    dump_coarsest_partition: bool = False
    dump_graph_hierarchy: bool = False
    dump_partition_hierarchy: bool = False
    dump_dir: str = "."


def context_to_dict(obj):
    """Context tree (any dataclass tree) -> plain nested dict: enums to
    values, numpy arrays to lists, inf to "inf" (the JAX package's
    context_to_dict)."""
    import dataclasses as _dc

    if _dc.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: context_to_dict(getattr(obj, f.name))
            for f in _dc.fields(obj)
        }
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [context_to_dict(x) for x in obj]
    if isinstance(obj, float) and obj == float("inf"):
        return "inf"
    return obj


@dataclass
class Context:
    """Root context (include/kaminpar-shm/kaminpar.h:550-562)."""

    preset_name: str = "default"
    partitioning: PartitioningSchemeContext = field(
        default_factory=PartitioningSchemeContext
    )
    partition: PartitionContext = field(default_factory=PartitionContext)
    coarsening: CoarseningContext = field(default_factory=CoarseningContext)
    initial_partitioning: InitialPartitioningContext = field(
        default_factory=InitialPartitioningContext
    )
    refinement: RefinementContext = field(default_factory=RefinementContext)
    parallel: ParallelContext = field(default_factory=ParallelContext)
    compression: GraphCompressionContext = field(
        default_factory=GraphCompressionContext
    )
    resilience: ResilienceContext = field(default_factory=ResilienceContext)
    external: ExternalContext = field(default_factory=ExternalContext)
    dynamic: DynamicContext = field(default_factory=DynamicContext)
    debug: DebugContext = field(default_factory=DebugContext)
    seed: int = 0

    def copy(self) -> "Context":
        import copy as pycopy

        return pycopy.deepcopy(self)
