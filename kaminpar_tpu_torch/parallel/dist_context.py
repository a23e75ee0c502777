"""Distributed context, presets, and factories (counterpart of
kaminpar_tpu/parallel/dist_context.py).

Mirrors the reference's distributed configuration surface: the enums of
kaminpar-dist factories.cc, the presets of kaminpar-dist/presets.cc and
the enum -> implementation factories.  The distributed context embeds a
shared-memory `Context` (used for the coarsest-graph initial
partitioning, as the reference runs shm KaMinPar on the replicated
coarsest graph) plus the dist-specific clusterer/refiner selections.
Every preset, clusterer and refiner of the JAX package is here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List

from ..context import Context, JetRefinementContext, PartitioningMode
from ..ops.lp import LPConfig
from ..presets import create_context_by_preset_name


class DistClusteringAlgorithm(str, enum.Enum):
    """kaminpar-dist factories.cc clusterer dispatch."""

    GLOBAL_NOOP = "global-noop"
    GLOBAL_LP = "global-lp"
    GLOBAL_HEM = "global-hem"
    GLOBAL_HEM_LP = "global-hem-lp"
    LOCAL_NOOP = "local-noop"
    LOCAL_LP = "local-lp"


class DistRefinementAlgorithm(str, enum.Enum):
    """kaminpar-dist factories.cc refiner dispatch."""

    NOOP = "noop"
    BATCHED_LP = "lp"
    COLORED_LP = "colored-lp"
    JET = "jet"
    NODE_BALANCER = "node-balancer"
    CLUSTER_BALANCER = "cluster-balancer"


class DistInitialPartitioningAlgorithm(str, enum.Enum):
    """kaminpar-dist factories.cc:72-88 initial partitioner dispatch."""

    KAMINPAR = "kaminpar"
    RANDOM = "random"
    MTKAHYPAR = "mtkahypar"


@dataclass
class DistContext:
    """dKaMinPar configuration (include/kaminpar-dist/dkaminpar.h Context
    analog).  `shm` configures coarsening limits, partition constraints and
    the coarsest-graph initial partitioning."""

    shm: Context = field(default_factory=lambda: create_context_by_preset_name("default"))
    # DEEP (deep_multilevel.cc lineage: coarsest partitioned at a reduced
    # k' with block spans, k doubled by mesh-side extension during
    # uncoarsening) or KWAY (kway_multilevel.cc: full k at the coarsest)
    mode: PartitioningMode = PartitioningMode.DEEP
    clustering: DistClusteringAlgorithm = DistClusteringAlgorithm.GLOBAL_LP
    refinement: List[DistRefinementAlgorithm] = field(
        default_factory=lambda: [
            DistRefinementAlgorithm.NODE_BALANCER,
            DistRefinementAlgorithm.BATCHED_LP,
        ]
    )
    jet: JetRefinementContext = field(default_factory=JetRefinementContext)
    initial_partitioning: DistInitialPartitioningAlgorithm = (
        DistInitialPartitioningAlgorithm.KAMINPAR
    )
    lp_num_iterations: int = 5
    clp_num_iterations: int = 5
    hem_rounds: int = 5
    # LP rating engine over the sharded COO layout (ops/rating.py):
    # "auto" resolves to dense / sort — the dist path has no measured
    # degree skew, and select_engine's skew quality gate keeps scatter
    # out without one; force "scatter" explicitly (--lp-rating) on
    # workloads known to be RMAT-class skewed.  sort2 is unavailable
    # here (no CSR row spans)
    lp_rating: str = "auto"
    # mesh-subgroup replication (deep_multilevel.cc:79-153 + replicator.cc
    # replicate_graph / distribute_best_partition analog): once the graph
    # drops below this many nodes PER DEVICE, G replicas coarsen
    # independently on D/G-device subgroups as one block-diagonal union
    # (parallel/replication.py) and the best replica's partition is kept.
    # 0 disables (coarse levels then idle most of the mesh).
    replication_min_nodes_per_device: int = 2048

    # convenience passthroughs used by the driver
    @property
    def seed(self) -> int:
        return self.shm.seed

    @seed.setter
    def seed(self, value: int) -> None:
        self.shm.seed = int(value)

    @property
    def coarsening(self):
        return self.shm.coarsening

    @property
    def partition(self):
        return self.shm.partition

    def copy(self) -> "DistContext":
        import copy as _copy

        return _copy.deepcopy(self)


def _base(shm_preset: str = "default") -> DistContext:
    return DistContext(shm=create_context_by_preset_name(shm_preset))


def create_dist_default_context() -> DistContext:
    """presets.cc create_default_context (dist): global LP coarsening,
    balancer + batched LP refinement."""
    return _base("default")


def create_dist_strong_context() -> DistContext:
    """presets.cc create_strong_context: adds Jet refinement on top of the
    default pipeline (europar23-strong lineage)."""
    ctx = _base("default")
    ctx.refinement = [
        DistRefinementAlgorithm.NODE_BALANCER,
        DistRefinementAlgorithm.BATCHED_LP,
        DistRefinementAlgorithm.JET,
    ]
    return ctx


def create_dist_fast_context() -> DistContext:
    ctx = _base("fast")
    ctx.lp_num_iterations = 3
    return ctx


def create_dist_largek_context() -> DistContext:
    return _base("largek")


def create_dist_xterapart_context() -> DistContext:
    """Memory-frugal preset: compressed shm pipeline on the coarsest
    graph (presets.cc create_xterapart_context lineage)."""
    return _base("terapart")


def create_dist_jet_context() -> DistContext:
    ctx = _base("default")
    ctx.refinement = [
        DistRefinementAlgorithm.NODE_BALANCER,
        DistRefinementAlgorithm.JET,
    ]
    return ctx


def create_dist_colored_lp_context() -> DistContext:
    ctx = _base("default")
    ctx.refinement = [
        DistRefinementAlgorithm.NODE_BALANCER,
        DistRefinementAlgorithm.COLORED_LP,
    ]
    return ctx


def create_dist_cluster_balancer_context() -> DistContext:
    """Hybrid balancing pipeline (factories.cc HYBRID_CLUSTER_BALANCER
    lineage): node balancer first, cluster balancer for the overloads
    single-node moves cannot fix, then batched LP."""
    ctx = _base("default")
    ctx.refinement = [
        DistRefinementAlgorithm.NODE_BALANCER,
        DistRefinementAlgorithm.CLUSTER_BALANCER,
        DistRefinementAlgorithm.BATCHED_LP,
    ]
    return ctx


def create_dist_noref_context() -> DistContext:
    ctx = _base("noref")
    ctx.refinement = []
    return ctx


_DIST_PRESETS = {
    "default": create_dist_default_context,
    "strong": create_dist_strong_context,
    "fast": create_dist_fast_context,
    "largek": create_dist_largek_context,
    "xterapart": create_dist_xterapart_context,
    "europar23-fast": create_dist_default_context,
    "europar23-strong": create_dist_strong_context,
    "jet": create_dist_jet_context,
    "colored-lp": create_dist_colored_lp_context,
    "cluster-balancer": create_dist_cluster_balancer_context,
    "noref": create_dist_noref_context,
}


def create_dist_context_by_preset_name(name: str) -> DistContext:
    try:
        return _DIST_PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown dist preset '{name}' (available: {sorted(_DIST_PRESETS)})"
        ) from None


def get_dist_preset_names():
    return set(_DIST_PRESETS)


# -- factories (kaminpar-dist/factories.cc analog) ------------------------

def create_dist_clusterer(ctx: DistContext) -> Callable:
    """Returns clusterer(graph, max_cluster_weight, seed) -> labels."""
    import torch

    from .dist_hem import dist_hem_cluster, dist_hem_lp_cluster
    from .dist_lp import dist_lp_cluster

    algo = ctx.clustering
    if algo in (
        DistClusteringAlgorithm.GLOBAL_NOOP,
        DistClusteringAlgorithm.LOCAL_NOOP,
    ):
        return lambda graph, mcw, seed: torch.arange(
            graph.n_pad, dtype=torch.int32, device=graph.mesh.device
        )
    if algo == DistClusteringAlgorithm.GLOBAL_LP:
        cfg = LPConfig(rating=ctx.lp_rating)
        return lambda graph, mcw, seed: dist_lp_cluster(
            graph, mcw, seed, cfg=cfg, num_iterations=ctx.lp_num_iterations
        )
    if algo == DistClusteringAlgorithm.LOCAL_LP:
        cfg = LPConfig(dist_local_only=True, rating=ctx.lp_rating)
        return lambda graph, mcw, seed: dist_lp_cluster(
            graph, mcw, seed, cfg=cfg, num_iterations=ctx.lp_num_iterations
        )
    if algo == DistClusteringAlgorithm.GLOBAL_HEM:
        return lambda graph, mcw, seed: dist_hem_cluster(
            graph, mcw, seed, num_rounds=ctx.hem_rounds
        )
    if algo == DistClusteringAlgorithm.GLOBAL_HEM_LP:
        return lambda graph, mcw, seed: dist_hem_lp_cluster(
            graph, mcw, seed, hem_rounds=ctx.hem_rounds
        )
    raise ValueError(f"unhandled clustering algorithm {algo}")


def create_dist_refiner(ctx: DistContext) -> Callable:
    """Returns refiner(graph, partition, k, max_block_weights, seed, level)
    running the configured refinement pipeline in order
    (factories.cc create_refiner + MultiRefiner analog)."""
    from .dist_balancer import dist_node_balance
    from .dist_clp import dist_colored_lp_refine
    from .dist_cluster_balancer import dist_cluster_balance
    from .dist_jet import dist_jet_refine
    from .dist_lp import dist_lp_refine

    algorithms = list(ctx.refinement)

    def refine(graph, partition, k, max_block_weights, seed, level=0):
        # k is shape-defining for the dist kernels too (see pad_k_bucket)
        from ..ops.segments import pad_k_bucket

        k, max_block_weights, _ = pad_k_bucket(k, max_block_weights)
        part = partition
        for j, algo in enumerate(algorithms):
            s = (int(seed) * 1013904223 + j * 12345) & 0x7FFFFFFF
            if algo == DistRefinementAlgorithm.NOOP:
                continue
            elif algo == DistRefinementAlgorithm.NODE_BALANCER:
                part = dist_node_balance(
                    graph, part, k, max_block_weights, s
                )
            elif algo == DistRefinementAlgorithm.CLUSTER_BALANCER:
                part = dist_cluster_balance(
                    graph, part, k, max_block_weights, s
                )
            elif algo == DistRefinementAlgorithm.BATCHED_LP:
                part = dist_lp_refine(
                    graph, part, k, max_block_weights, s,
                    num_iterations=ctx.lp_num_iterations,
                )
            elif algo == DistRefinementAlgorithm.COLORED_LP:
                part = dist_colored_lp_refine(
                    graph, part, k, max_block_weights, s,
                    num_iterations=ctx.clp_num_iterations,
                )
            elif algo == DistRefinementAlgorithm.JET:
                part = dist_jet_refine(
                    graph, part, k, max_block_weights, s,
                    ctx=ctx.jet, level=level,
                )
            else:  # pragma: no cover
                raise ValueError(f"unhandled refinement algorithm {algo}")
        return part

    return refine
