"""Named presets (counterpart of kaminpar_tpu/presets.py; presets.cc:18-100).

Each preset builds a filled-in Context, field for field the JAX package's.
The `terapart*` presets switch on compressed-graph mode: `set_graph`
compresses the input and the deep scheme uploads it chunk by chunk.
"""

from __future__ import annotations

from typing import Set

from .context import (
    ClusterWeightLimit,
    CoarseningAlgorithm,
    Context,
    PartitioningMode,
    RefinementAlgorithm,
    TwoHopStrategy,
)


def create_default_context() -> Context:
    """presets.cc:102-301 (deep multilevel, LP coarsening) with the JAX
    package's two deviations from the reference's default: Jet then an
    afterburned LP pass as the refiners (the bulk-synchronous rounds need
    Jet's filtered move selection), and refinement after every
    k-doubling extension."""
    ctx = Context(preset_name="default")
    # Jet then an afterburned-LP polish pass; two Jet rounds on the
    # finest level
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.JET,
        RefinementAlgorithm.LABEL_PROPAGATION,
    ]
    ctx.refinement.jet.num_rounds_on_fine_level = 2
    ctx.partitioning.refine_after_extending_partition = True
    return ctx


def create_fast_context() -> Context:
    """presets.cc:301-309: single LP iteration, single IP repetition."""
    ctx = create_default_context()
    ctx.preset_name = "fast"
    ctx.coarsening.clustering.lp.num_iterations = 1
    ctx.initial_partitioning.pool.min_num_repetitions = 1
    ctx.initial_partitioning.pool.min_num_non_adaptive_repetitions = 1
    ctx.initial_partitioning.pool.max_num_repetitions = 1
    ctx.partitioning.light_intermediate_refinement = True
    return ctx


def create_strong_context() -> Context:
    """presets.cc:311-324: adds k-way FM between refinement and final
    balancing (Jet plays the reference's LP slot, see default).  The
    localized batch FM (native/fm.cpp) runs on the finest levels,
    alternated with Jet: FM escapes Jet's bulk-move local optimum, and
    Jet re-polishes the FM result."""
    ctx = create_default_context()
    ctx.preset_name = "strong"
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.JET,
        RefinementAlgorithm.GREEDY_FM,
        RefinementAlgorithm.JET,
        RefinementAlgorithm.GREEDY_FM,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    ]
    # intermediate extensions get single-round Jet and skip FM; the
    # final extension's refine at each level is the real polish
    ctx.partitioning.light_intermediate_refinement = True
    return ctx


def create_largek_context() -> Context:
    """presets.cc:326-334: fewer IP repetitions for huge k.  Refinement
    avoids every dense (n, k) structure — Jet's connection table cannot
    exist at the reference's k=30,000 claim (README.MD:17); LP refinement
    rates through the sort engine and the balancers switch to edge
    aggregation above ops/balancer.BALANCER_DENSE_MAX_K."""
    ctx = create_default_context()
    ctx.preset_name = "largek"
    ctx.initial_partitioning.pool.min_num_repetitions = 4
    ctx.initial_partitioning.pool.min_num_non_adaptive_repetitions = 2
    ctx.initial_partitioning.pool.max_num_repetitions = 4
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.LABEL_PROPAGATION,
    ]
    return ctx


def create_largek_fast_context() -> Context:
    ctx = create_largek_context()
    ctx.preset_name = "largek-fast"
    pool = ctx.initial_partitioning.pool
    pool.min_num_repetitions = 2
    pool.min_num_non_adaptive_repetitions = 1
    pool.max_num_repetitions = 2
    pool.enable_ggg_bipartitioner = False
    pool.refinement.disabled = True
    pool.refinement.num_iterations = 1
    return ctx


def create_largek_strong_context() -> Context:
    ctx = create_largek_context()
    ctx.preset_name = "largek-strong"
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.LABEL_PROPAGATION,
        RefinementAlgorithm.GREEDY_FM,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    ]
    return ctx


def create_jet_context(rounds: int = 1) -> Context:
    """presets.cc:372-391: Jet instead of LP refinement."""
    ctx = create_default_context()
    ctx.preset_name = "jet" if rounds == 1 else f"{rounds}xjet"
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.JET,
    ]
    if rounds > 1:
        jet = ctx.refinement.jet
        jet.num_rounds_on_coarse_level = rounds
        jet.num_rounds_on_fine_level = rounds
        jet.initial_gain_temp_on_coarse_level = 0.75
        jet.initial_gain_temp_on_fine_level = 0.75
        jet.final_gain_temp_on_coarse_level = 0.25
        jet.final_gain_temp_on_fine_level = 0.25
    return ctx


def create_noref_context() -> Context:
    ctx = create_default_context()
    ctx.preset_name = "noref"
    ctx.refinement.algorithms = []
    return ctx


def create_vcycle_context(restrict_refinement: bool = False) -> Context:
    """presets.cc:422-436."""
    ctx = create_default_context()
    ctx.preset_name = "restricted-vcycle" if restrict_refinement else "vcycle"
    ctx.partitioning.mode = PartitioningMode.VCYCLE
    if restrict_refinement:
        ctx.partitioning.restrict_vcycle_refinement = True
        ctx.refinement.algorithms = [RefinementAlgorithm.LABEL_PROPAGATION]
    return ctx


def _terapartify(ctx: Context) -> Context:
    """presets.cc terapartify_context: enable compressed-graph mode."""
    ctx.compression.enabled = True
    ctx.preset_name = "terapart"
    return ctx


def create_terapart_context() -> Context:
    return _terapartify(create_default_context())


def create_terapart_strong_context() -> Context:
    ctx = _terapartify(create_strong_context())
    ctx.preset_name = "terapart-strong"
    return ctx


def create_terapart_largek_context() -> Context:
    ctx = _terapartify(create_largek_context())
    ctx.preset_name = "terapart-largek"
    ctx.coarsening.clustering.forced_kc_level = True
    return ctx


def create_esa21_smallk_context() -> Context:
    """presets.cc create_esa21_smallk_context: the ESA'21 configuration.
    The reference switches to BUFFERED contraction + single-phase LP; the
    device pipeline has one contraction and one LP implementation, so this
    is the default pipeline under the historical name."""
    ctx = create_default_context()
    ctx.preset_name = "esa21-smallk"
    return ctx


def create_esa21_largek_context() -> Context:
    ctx = create_esa21_smallk_context()
    ctx.preset_name = "esa21-largek"
    ctx.initial_partitioning.pool.min_num_repetitions = 4
    ctx.initial_partitioning.pool.min_num_non_adaptive_repetitions = 2
    ctx.initial_partitioning.pool.max_num_repetitions = 4
    return ctx


def create_esa21_largek_fast_context() -> Context:
    ctx = create_esa21_largek_context()
    ctx.preset_name = "esa21-largek-fast"
    pool = ctx.initial_partitioning.pool
    pool.min_num_repetitions = 2
    pool.min_num_non_adaptive_repetitions = 1
    pool.max_num_repetitions = 2
    return ctx


def create_esa21_strong_context() -> Context:
    ctx = create_esa21_smallk_context()
    ctx.preset_name = "esa21-strong"
    ctx.refinement.algorithms = [
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
        RefinementAlgorithm.LABEL_PROPAGATION,
        RefinementAlgorithm.GREEDY_FM,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    ]
    return ctx


def create_linear_time_kway_context() -> Context:
    """presets.cc create_linear_time_kway_context: mtkahypar-kway with
    sparsification clustering (linear-time MGP, arXiv 2504.17615)."""
    ctx = create_mtkahypar_kway_context()
    ctx.preset_name = "linear-time-kway"
    ctx.coarsening.algorithm = CoarseningAlgorithm.SPARSIFICATION_CLUSTERING
    return ctx


def create_mtkahypar_kway_context() -> Context:
    """presets.cc:488-499: Mt-KaHyPar-style coarsening + direct k-way."""
    ctx = create_default_context()
    ctx.preset_name = "mtkahypar-kway"
    cl = ctx.coarsening.clustering
    cl.lp.num_iterations = 1
    cl.cluster_weight_limit = ClusterWeightLimit.BLOCK_WEIGHT
    cl.cluster_weight_multiplier = 1.0 / 160.0
    cl.shrink_factor = 2.5
    cl.lp.two_hop_strategy = TwoHopStrategy.CLUSTER
    ctx.coarsening.contraction_limit = 160
    ctx.partitioning.mode = PartitioningMode.KWAY
    return ctx


_PRESETS = {
    "default": create_default_context,
    "fast": create_fast_context,
    "strong": create_strong_context,
    "fm": create_strong_context,
    "largek": create_largek_context,
    "largek-fast": create_largek_fast_context,
    "largek-strong": create_largek_strong_context,
    "jet": create_jet_context,
    "4xjet": lambda: create_jet_context(4),
    "noref": create_noref_context,
    "vcycle": lambda: create_vcycle_context(False),
    "restricted-vcycle": lambda: create_vcycle_context(True),
    "esa21": create_esa21_smallk_context,
    "esa21-smallk": create_esa21_smallk_context,
    "esa21-largek": create_esa21_largek_context,
    "esa21-largek-fast": create_esa21_largek_fast_context,
    "esa21-strong": create_esa21_strong_context,
    "diss": create_esa21_smallk_context,
    "diss-smallk": create_esa21_smallk_context,
    "diss-largek": create_esa21_largek_context,
    "diss-largek-fast": create_esa21_largek_fast_context,
    "diss-strong": create_esa21_strong_context,
    "mtkahypar-kway": create_mtkahypar_kway_context,
    "linear-time-kway": create_linear_time_kway_context,
    "terapart": create_terapart_context,
    "terapart-strong": create_terapart_strong_context,
    "terapart-largek": create_terapart_largek_context,
}


def create_context_by_preset_name(name: str) -> Context:
    """presets.cc:18-73."""
    if name not in _PRESETS:
        raise ValueError(
            f"invalid preset name: {name!r} (available: "
            f"{sorted(get_preset_names())})"
        )
    return _PRESETS[name]()


def get_preset_names() -> Set[str]:
    """Every preset name the JAX package knows (presets.cc:76-99)."""
    return set(_PRESETS)
