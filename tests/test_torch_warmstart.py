"""The rest of the port's single-device facade: the warm start
`set_initial_partition(partition, max_levels)` of the v-cycle scheme,
`copy_graph` and `set_output_level`.

Warm-started runs must equal kaminpar_tpu's bitwise with `max_levels`
None, 0 (refinement only) and 2, on a graph with isolated nodes (the warm
labels follow the core permutation) and on one without.  The warm start
is one-shot: the next call runs the full v-cycle preset again, and a call
that raises clears it too.  A warm partition of the wrong length raises
before the core permutation reads it.
"""

import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch.utils import logger
from test_torch_schemes import CASES, port_context, run_preset
from torch_threads import one_torch_thread  # noqa: F401


def _warm(n: int, k: int) -> np.ndarray:
    """A valid k-way labeling: k contiguous ranges of node ids."""
    return (np.arange(n) * k // n).astype(np.int32)


def _solvers(host):
    jctx = jax_preset("vcycle")
    jctx.coarsening.contraction_limit = 160
    tctx = port_context(jctx)
    jsolver = kt.KaMinPar(jctx)
    jsolver.set_output_level(0)
    jsolver.set_graph(host)
    tsolver = kp.KaMinPar(tctx, device="cpu").set_graph(
        kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                     host.edge_weights))
    tsolver.set_output_level(0)
    return jsolver, tsolver


WARM_CASES = {
    "rmat-k8": CASES["rmat-k8"],  # with isolated nodes
    "grid-k4": (lambda: jfactories.make_grid_graph(64, 64), 4),  # none
}


@pytest.mark.parametrize("case,max_levels", [
    ("rmat-k8", None), ("rmat-k8", 0), ("rmat-k8", 2), ("grid-k4", 2),
])
def test_warm_start_bitwise_equal(case, max_levels):
    make, k = WARM_CASES[case]
    host = make()
    isolated = int((np.diff(host.xadj) == 0).sum())
    assert (isolated > 0) == (case == "rmat-k8")
    warm = _warm(host.n, k)
    jsolver, tsolver = _solvers(host)
    jpart = np.asarray(jsolver.set_initial_partition(
        warm, max_levels=max_levels).compute_partition(
        k=k, epsilon=0.03, seed=1))
    tpart = tsolver.set_initial_partition(
        warm, max_levels=max_levels).compute_partition(
        k=k, epsilon=0.03, seed=1)
    np.testing.assert_array_equal(tpart, jpart)
    assert tsolver.last_gate["valid"]
    assert set(tsolver.last_timings) == {"vcycle-0"}  # no deep run


def test_warm_start_is_one_shot():
    """The next call is the plain v-cycle preset (deep run, then a cycle);
    a call that raises on a bad warm start clears it as well."""
    make, k = CASES["rmat-k8"]
    host = make()
    _, tsolver = _solvers(host)
    tsolver.set_initial_partition(_warm(host.n, k), max_levels=0)
    tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    assert tsolver._warm_part is None and tsolver._warm_levels is None
    again = tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    assert any(name.startswith("deep/") for name in tsolver.last_timings)
    jpart, tpart = run_preset("vcycle", host, k)
    np.testing.assert_array_equal(again, jpart)
    np.testing.assert_array_equal(tpart, jpart)
    tsolver.set_initial_partition(_warm(host.n, k)[:-1], max_levels=0)
    with pytest.raises(ValueError, match="shape"):
        tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    assert tsolver._warm_part is None
    tsolver.set_initial_partition(np.full(host.n, k, dtype=np.int32))
    with pytest.raises(ValueError, match="out of range"):
        tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    assert tsolver._warm_part is None


def test_copy_graph_and_output_level(capsys):
    """copy_graph partitions as set_graph does; an instance's output level
    holds only while it computes: QUIET prints nothing and leaves the
    global level alone, the default prints the banner and RESULT line."""
    host = kp.make_rmat(1 << 10, 4000, seed=3)
    ctx = kp.context_from_preset("default")
    ctx.coarsening.contraction_limit = 160
    a = kp.KaMinPar(ctx, device="cpu").set_graph(host)
    b = kp.KaMinPar(ctx.copy(), device="cpu").copy_graph(
        host.xadj.tolist(), host.adjncy.tolist(), None,
        host.edge_weights.tolist())
    assert logger.output_level() == logger.OutputLevel.APPLICATION
    capsys.readouterr()
    # while a QUIET instance computes, the package's logger is QUIET (its
    # warnings too), and the global level is back afterwards
    during = []
    inner = a._partition_with_isolated
    a._partition_with_isolated = lambda *args: (
        during.append(logger.output_level()), inner(*args))[1]
    pa = a.set_output_level(logger.OutputLevel.QUIET).compute_partition(
        k=4, epsilon=0.03, seed=1)
    assert during == [logger.OutputLevel.QUIET]
    assert capsys.readouterr().err == ""
    assert logger.output_level() == logger.OutputLevel.APPLICATION
    pb = b.compute_partition(k=4, epsilon=0.03, seed=1)
    err = capsys.readouterr().err
    np.testing.assert_array_equal(pa, pb)
    assert "kaminpar-tpu-torch v" in err and "preset 'default'" in err
    cut = int(host.edge_weights[pb[host.edge_sources()]
                                != pb[host.adjncy]].sum() // 2)
    assert f"RESULT cut={cut} " in err and "feasible=1 k=4" in err
