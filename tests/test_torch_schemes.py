"""The k-way and recursive-bipartitioning schemes end to end through the
facade: kaminpar_tpu_torch.KaMinPar(ctx, device="cpu")
returns kaminpar_tpu.KaMinPar(ctx)'s partition, bitwise, for the same
graph, context and seed.

Both packages are configured from one source: the JAX preset's context,
adjusted, is turned into the port's with convert.context_from_dict.  The
contraction limit is 160 so that these small graphs coarsen through
several levels.  `run_preset` is shared with the other end-to-end files;
the JAX package's compiled programs are kept across the runs of a file
(conftest clears them between files).
"""

import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.context import PartitioningMode
from kaminpar_tpu.context import context_to_dict as jax_context_to_dict
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch.context import Context, context_to_dict
from kaminpar_tpu_torch.convert import context_from_dict
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "rmat-k8": (lambda: jfactories.make_rmat(1 << 12, 30_000, seed=3), 8),
    "rgg-k4": (lambda: jfactories.make_rgg2d(1 << 12, seed=1), 4),
}

# fields of the JAX package's context that the port does not have: the
# subtrees of dynamic sessions and debug dumps, and knobs that the JAX
# package accepts for parity with the reference and reads nowhere
JAX_ONLY = {
    "dynamic", "debug",
    "coarsening.clustering.lp.large_degree_threshold",
    "coarsening.clustering.lp.max_num_neighbors",
    "coarsening.clustering.lp.two_hop_threshold",
    "initial_partitioning.coarsening.large_degree_threshold",
    "initial_partitioning.coarsening.cluster_weight_limit",
    "initial_partitioning.refinement.improvement_abortion_threshold",
    "initial_partitioning.pool.refinement.improvement_abortion_threshold",
    "partitioning.deep_initial_partitioning_load",
    "partition.total_edge_weight",
}


def split_jax_dict(data, port=None, path=""):
    """(the part of a JAX context dict that the port's Context has, the
    dotted names of the fields it lacks)."""
    if port is None:
        port = context_to_dict(Context())
    kept, dropped = {}, set()
    for key, value in data.items():
        name = f"{path}{key}"
        if key not in port:
            dropped.add(name)
        elif isinstance(value, dict):
            kept[key], sub = split_jax_dict(value, port[key], name + ".")
            dropped |= sub
        else:
            kept[key] = value
    return kept, dropped


def port_context(jax_ctx):
    kept, dropped = split_jax_dict(jax_context_to_dict(jax_ctx))
    assert dropped == JAX_ONLY
    return context_from_dict(kept)


def run_preset(preset, host, k, configure=None, seed=1):
    """(JAX partition, port partition) for one graph under `preset`, after
    `configure(ctx)` on the JAX context."""
    jctx = jax_preset(preset)
    jctx.coarsening.contraction_limit = 160
    if configure is not None:
        configure(jctx)
    tctx = port_context(jctx)
    solver = kt.KaMinPar(jctx)
    solver.set_output_level(0)
    jpart = np.asarray(solver.set_graph(host).compute_partition(
        k=k, epsilon=0.03, seed=seed))
    tgraph = kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                          host.edge_weights)
    tpart = kp.KaMinPar(tctx, device="cpu").set_graph(
        tgraph).compute_partition(k=k, epsilon=0.03, seed=seed)
    assert tpart.dtype == np.int32 and tpart.shape == (host.n,)
    assert tpart.min() >= 0 and tpart.max() < k
    return jpart, tpart


def _rb(ctx):
    ctx.partitioning.mode = PartitioningMode.RB


def _rb_refined(ctx):
    _rb(ctx)
    ctx.partitioning.rb_enable_kway_toplevel_refinement = True


SCHEMES = {
    "mtkahypar-kway": ("mtkahypar-kway", None),
    "rb": ("default", _rb),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_scheme_bitwise_equal(scheme, case):
    """The k-way scheme (mtkahypar-kway) and the RB scheme; the v-cycle
    schemes are in test_torch_vcycle.py."""
    preset, configure = SCHEMES[scheme]
    make, k = CASES[case]
    jpart, tpart = run_preset(preset, make(), k, configure)
    np.testing.assert_array_equal(jpart, tpart)


def test_rb_with_toplevel_refinement_bitwise_equal():
    """The RB scheme's optional device refinement of the k-way result."""
    make, k = CASES["rmat-k8"]
    jpart, tpart = run_preset("default", make(), k, _rb_refined)
    np.testing.assert_array_equal(jpart, tpart)


def test_external_scheme_raises(monkeypatch):
    """The external scheme runs (it used to raise).  A declared budget
    that cannot hold even the floor chunk's stream state sends the memory
    governor to its host-only rung; with the governor switched off the
    scheme raises DeviceOOM."""
    ctx = kp.context_from_preset("default")
    ctx.partitioning.mode = kp.context.PartitioningMode.EXTERNAL
    ctx.coarsening.contraction_limit = 20
    graph = kp.make_rmat(1 << 8, 900, seed=1)
    solver = kp.KaMinPar(ctx, device="cpu").set_graph(graph)
    part = solver.compute_partition(k=2, epsilon=0.03, seed=1)
    assert part.shape == (graph.n,) and set(np.unique(part)) == {0, 1}
    assert solver.last_external["streamed_levels"] >= 1
    assert solver.last_gate["valid"]
    ctx.resilience.memory_budget = 1000.0
    part = solver.compute_partition(k=2, epsilon=0.03, seed=1)
    assert part.shape == (graph.n,) and solver.last_gate["valid"]
    assert kp.resilience.memory.summary()["rung_name"] == "host-only"
    monkeypatch.setenv("KAMINPAR_TPU_MEM_GOVERNOR", "0")
    with pytest.raises(kp.resilience.DeviceOOM, match="floor stream state"):
        solver.compute_partition(k=2, epsilon=0.03, seed=1)


def test_context_from_dict_raises_on_a_field_the_port_lacks():
    data = jax_context_to_dict(jax_preset("default"))
    with pytest.raises(ValueError, match="has no field"):
        context_from_dict(data)
    kept, _ = split_jax_dict(data)
    kept["coarsening"]["no_such_knob"] = 1
    with pytest.raises(ValueError, match="coarsening.no_such_knob"):
        context_from_dict(kept)
