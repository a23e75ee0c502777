"""The port's memory governor against the JAX package's, at zero
tolerance: the estimator and `rung_fits` for every rung and pad policy,
the rung `begin_run` picks for a list of budgets, and on the n = 2^14 RMAT
graph at k = 8 the runs of PERF.md's resilience cells — forced rungs 1-4,
a budget that begins at rung 2 and one that begins at rung 3, an injected
OOM and the kill switch — each bitwise against the JAX package's, the
"= default" rows also against the uninterrupted partition.  Rung
exhaustion raises DeviceOOM with `rungs_exhausted`, the spill tier
(rung 2) restores every level bitwise, and rung 3's stream hands its
work to the host LP only on a classified degradation.

The `memory-pressure` events read the live device bytes, which are
`torch.cuda.memory_allocated` on the card and 0 on the CPU, so they may
differ between the packages; nothing else does.
"""

import numpy as np
import pytest
import torch

from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.resilience import memory as jmem
from kaminpar_tpu_torch import caching as tcaching
from kaminpar_tpu_torch.resilience import memory as tmem
from test_torch_resilience import (  # noqa: F401
    _clean,
    assert_same,
    run_one,
    run_pair,
)
from torch_threads import one_torch_thread  # noqa: F401

K = 8


@pytest.fixture(scope="module")
def parity_graph():
    """The smoke's parity graph: n = 2^14, 120,000 edge draws."""
    return jfactories.make_rmat(1 << 14, 120_000, seed=3)


@pytest.fixture(scope="module")
def uninterrupted(parity_graph):
    run = run_one("jax", "default", parity_graph, K, contraction_limit=2000)
    return run.part


SHAPES = [(0, 0, 2), (10, 20, 2), (4095, 30_000, 8), (1 << 14, 239_774, 8),
          (65_536, 1_083_716, 16), (1 << 20, 19_074_100, 16),
          (572_702, 19_074_100, 128)]


@pytest.mark.parametrize("n,m,k", SHAPES)
def test_estimator_equal_for_every_rung_and_pad_mode(n, m, k):
    for mode in ("bucketed", "tight"):
        assert tmem.padded_bucket(n, m, k, mode) == jmem.padded_bucket(
            n, m, k, mode)
    for rung in range(5):
        assert tmem.estimate_rung_bytes(rung, n, m, k) == (
            jmem.estimate_rung_bytes(rung, n, m, k))
        for budget in (10 ** 4, 10 ** 5, 3 * 10 ** 6, 24 << 20, 16 << 20,
                       10 ** 9, 10 ** 11):
            assert tmem.rung_fits(rung, n, m, k, budget) == (
                jmem.rung_fits(rung, n, m, k, budget))


def test_pad_policy_scope():
    assert tcaching.pad_policy() == "bucketed"
    assert tcaching.pad_size(1000) == 1024
    with tcaching.pad_policy_scope("tight"):
        assert tcaching.pad_size(1000) == 1024
        assert tcaching.pad_size(1025) == 1280
        assert tcaching.pad_size(100) == 256
    assert tcaching.pad_size(1025) == 2048
    with pytest.raises(ValueError):
        with tcaching.pad_policy_scope("loose"):
            pass


def _begin(mem, budget, n, m, k):
    class Partition:
        pass

    class Resilience:
        memory_budget = float(budget)

    class Ctx:
        partition = Partition()
        resilience = Resilience()

    Ctx.partition.k = k

    class Graph:
        pass

    g = Graph()
    g.n, g.m = n, m
    st = mem.begin_run(g, Ctx())
    return st.rung, st.estimate, st.bucket, mem.summary()


@pytest.mark.parametrize("budget", [
    0, 10 ** 5, 10 ** 6, 3 * 10 ** 6, 4_500_000, 5_500_000, 7 * 10 ** 6,
    16 << 20, 24 << 20, 50 << 20, 10 ** 9,
])
def test_begin_run_picks_the_same_rung(budget):
    for n, m, k in SHAPES[2:6]:
        assert _begin(tmem, budget, n, m, k) == _begin(jmem, budget, n, m, k)


def test_the_budgets_of_the_parity_cells(parity_graph):
    """4,500,000 bytes begins at rung 2 on the parity graph, 1,000,000 at
    rung 3 (the rung-3 floor fits, rung 2 does not)."""
    g = parity_graph
    assert _begin(tmem, 4_500_000, g.n, g.m, K)[0] == 2
    assert _begin(tmem, 1_000_000, g.n, g.m, K)[0] == 3


@pytest.mark.parametrize("rung", [1, 2, 3, 4])
def test_forced_rung_bitwise(parity_graph, uninterrupted, rung):
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_MEM_RUNG": rung},
                    contraction_limit=2000)
    assert_same(j, t)
    assert t.events["memory-budget"] == j.events["memory-budget"]
    assert t.solver.ctx.partition.k == K
    if rung <= 2:  # "= default": tight pads and spills change nothing
        np.testing.assert_array_equal(t.part, uninterrupted)
    if rung == 2:
        assert t.events["memory-spill"] == j.events["memory-spill"]
        assert t.events["memory-reload"] == j.events["memory-reload"]
    if rung == 3:
        assert t.events["stream"] and len(t.events["stream"]) == len(
            j.events["stream"])
    if rung == 4:
        assert t.events["host-only-partition"] == (
            j.events["host-only-partition"])


@pytest.mark.parametrize("budget,rung", [(4_500_000, 2), (1_000_000, 3)])
def test_budget_bitwise(parity_graph, uninterrupted, budget, rung):
    def configure(ctx):
        ctx.resilience.memory_budget = float(budget)

    j, t = run_pair("default", parity_graph, K, configure=configure,
                    contraction_limit=2000)
    assert_same(j, t)
    assert [e["rung"] for e in t.events["memory-budget"]] == [rung]
    assert t.events["memory-budget"] == j.events["memory-budget"]
    if rung == 2:
        np.testing.assert_array_equal(t.part, uninterrupted)


def test_injected_oom_and_kill_switch(parity_graph, uninterrupted):
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_FAULTS": "device-oom:nth=1"},
                    contraction_limit=2000)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, uninterrupted)
    assert [(d["site"], d["rung"], d["injected"]) for d in t.degraded] == [
        ("device-oom", 1, True)]
    # with the governor off, the same fault is not absorbed
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_FAULTS": "device-oom:nth=1",
                         "KAMINPAR_TPU_MEM_GOVERNOR": "0"},
                    contraction_limit=2000)
    assert_same(j, t)
    assert type(t.error).__name__ == "DeviceOOM"


def test_rungs_exhausted_raises(parity_graph):
    """When the host-only rung fails too, nothing is left to fall back
    to: DeviceOOM with `rungs_exhausted`."""
    def boom(*args, **kwargs):
        raise MemoryError("host allocation failed in the test")

    import kaminpar_tpu.resilience.memory as jm
    import kaminpar_tpu_torch.resilience.memory as tm

    saved = (jm.host_only_partition, tm.host_only_partition)
    jm.host_only_partition = tm.host_only_partition = boom
    try:
        j, t = run_pair("default", parity_graph, K,
                        env={"KAMINPAR_TPU_MEM_RUNG": 4},
                        contraction_limit=2000)
    finally:
        jm.host_only_partition, tm.host_only_partition = saved
    assert_same(j, t)
    assert t.error.rungs_exhausted and j.error.rungs_exhausted
    assert tmem.summary()["exhausted"]


def test_rung_2_spills_and_reloads_bitwise():
    """With a deeper hierarchy (contraction limit 40) rung 2 spills the
    cold levels at every barrier and reloads them on the way up."""
    host = jfactories.make_rmat(1 << 11, 12_000, seed=3)
    base = run_one("port", "default", host, K, contraction_limit=40)
    j, t = run_pair("default", host, K, env={"KAMINPAR_TPU_MEM_RUNG": 2},
                    contraction_limit=40)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, base.part)
    assert t.events["memory-spill"]
    assert t.events["memory-spill"] == j.events["memory-spill"]
    assert t.events["memory-reload"] == j.events["memory-reload"]
    summary = tmem.summary()
    assert summary["spills"]["count"] == len(t.events["memory-spill"])


def test_spill_restores_every_level_bitwise(parity_graph):
    """Spilling the whole hierarchy to the host and restoring it level by
    level gives back the same tensors in the same pad buckets."""
    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graphs.csr import device_graph_from_host
    from kaminpar_tpu_torch.partitioning.coarsener import Coarsener

    ctx = kp.context_from_preset("default")
    ctx.coarsening.contraction_limit = 200
    g = parity_graph
    host = kp.HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)
    ctx.partition.setup(host, k=K, epsilon=0.03)
    dg = device_graph_from_host(host, "cpu")
    c = Coarsener(ctx, dg, host.n)
    while c.current_n > 400 and c.coarsen():
        pass
    assert c.level >= 3
    before = [(lvl.coarse.graph, lvl.coarse.cmap) for lvl in c.levels]
    freed = c.spill_cold_levels(keep_last=0)
    assert freed > 0 and all(lvl.coarse is None for lvl in c.levels)
    for i in range(len(c.levels)):
        c._restore_level(i)
    for (graph, cmap), lvl in zip(before, c.levels):
        for name in ("row_ptr", "src", "dst", "edge_w", "node_w"):
            assert np.array_equal(getattr(graph, name).numpy(),
                                  getattr(lvl.coarse.graph, name).numpy())
        assert np.array_equal(cmap.numpy(), lvl.coarse.cmap.numpy())


def _fail_stream(monkeypatch, jax_exc, port_exc):
    """Make rung 3's device-streamed external scheme raise in each
    package: the JAX package's `external_partition`, the port's
    `ExternalPartitioner.partition`."""
    import kaminpar_tpu.external.driver as jdriver
    import kaminpar_tpu_torch.external.driver as tdriver

    def jax_boom(graph, ctx, facade=None):
        raise jax_exc

    def port_boom(self, graph):
        raise port_exc

    monkeypatch.setattr(jdriver, "external_partition", jax_boom)
    monkeypatch.setattr(tdriver.ExternalPartitioner, "partition", port_boom)


def test_rung3_injected_stream_fault_takes_the_host_lp(parity_graph,
                                                       monkeypatch):
    """An injected fault in rung 3's stream degrades, in both packages, to
    `semi_external_partition` (host-chunked LP) with the same `degraded`
    event and the same partition."""
    from kaminpar_tpu.resilience import errors as jerrors
    from kaminpar_tpu_torch.resilience import errors as terrors

    text = "injected fault at site 'native-build'"
    _fail_stream(monkeypatch,
                 jerrors.NativeUnavailable(text, site="native-build",
                                           injected=True),
                 terrors.NativeUnavailable(text, site="native-build",
                                           injected=True))
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_MEM_RUNG": 3},
                    contraction_limit=2000)
    assert_same(j, t)
    assert [(d["site"], d["error"]) for d in t.degraded] == [
        ("device-oom", "MemoryBudgetExceeded"),
        ("semi-external-stream", "NativeUnavailable")]
    assert t.events["semi-external"]
    assert t.events["semi-external"] == j.events["semi-external"]
    assert not t.events["stream"]


def test_rung3_stream_oom_moves_to_host_only(parity_graph, monkeypatch):
    """A raw out-of-memory error in rung 3's stream (torch's own class in
    the port) is the ladder's: both packages finish at rung 4, bitwise."""
    text = "CUDA out of memory. Tried to allocate 2.00 GiB"
    _fail_stream(monkeypatch, RuntimeError(text),
                 torch.OutOfMemoryError(text))
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_MEM_RUNG": 3},
                    contraction_limit=2000)
    # the detail names the raw exception's class
    assert_same(j, t, skip=("detail",))
    assert [(d["site"], d["rung"]) for d in t.degraded] == [
        ("device-oom", 3), ("device-oom", 4)]
    assert t.degraded[1]["detail"] == f"OutOfMemoryError: {text}"
    assert t.events["host-only-partition"] == (
        j.events["host-only-partition"])


def test_rung3_stream_device_fault_propagates(parity_graph, monkeypatch):
    """Any other failure of the stream (a kernel that does not launch, a
    CUDA error) is raised by the port, never hidden behind the host LP,
    where the JAX package falls back on every non-OOM exception."""
    text = "CUDA error: an illegal memory access was encountered"
    _fail_stream(monkeypatch, RuntimeError(text), RuntimeError(text))
    t = run_one("port", "default", parity_graph, K,
                env={"KAMINPAR_TPU_MEM_RUNG": 3}, contraction_limit=2000)
    assert type(t.error) is RuntimeError and str(t.error) == text
    assert [d["site"] for d in t.degraded] == ["device-oom"]  # the forcing
    assert not t.events["semi-external"]
