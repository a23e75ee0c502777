"""The whole default path: kaminpar_tpu_torch.KaMinPar("default",
device="cpu") returns the partition of kaminpar_tpu.KaMinPar("default"),
bitwise, for the same graph and seed.

Both sides run the same initial bipartitioner: the native one by default,
the numpy one under KAMINPAR_TPU_NO_NATIVE_IP=1 (each case runs both), with
the contraction limit at 160 so these small graphs coarsen through several
levels.  This file takes the host extension path (levels below the
device-extension size read the level back and extract blocks with numpy)
with the device bipartition pipeline lowered to blocks of 64 nodes;
test_torch_endtoend_device.py forces the device extension path on the
same CASES through the same run_both (a file of its own, so that each
file stays within its time on one test worker).
"""

import jax
import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu_torch import native
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "rmat-k8": (lambda: jfactories.make_rmat(1 << 12, 30_000, seed=3), 8),
    "rgg-k4": (lambda: jfactories.make_rgg2d(1 << 12, seed=1), 4),
}


def run_both(host, k, device_bipartition_threshold=None):
    """(JAX partition, port partition) for one graph."""
    parts = []
    for pkg, graph in (
        (kt, host),
        (kp, kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                          host.edge_weights)),
    ):
        solver = (pkg.KaMinPar("default") if pkg is kt
                  else pkg.KaMinPar("default", device="cpu"))
        solver.ctx.coarsening.contraction_limit = 160
        if device_bipartition_threshold is not None:
            solver.ctx.partitioning.device_bipartition_threshold = (
                device_bipartition_threshold
            )
        if pkg is kt:
            solver.set_output_level(0)
        parts.append(np.asarray(solver.set_graph(graph).compute_partition(
            k=k, epsilon=0.03, seed=1
        )))
    return parts


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_path_bitwise_equal(case, monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_NO_NATIVE_IP", "1")
    make, k = CASES[case]
    host = make()
    jax.clear_caches()
    jpart, tpart = run_both(host, k, device_bipartition_threshold=64)
    assert tpart.dtype == np.int32
    assert tpart.shape == (host.n,)
    assert tpart.min() >= 0 and tpart.max() < k
    np.testing.assert_array_equal(jpart, tpart)


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_path_bitwise_equal_with_native_ip(case, monkeypatch):
    """The default path as users get it: the JAX package runs its native
    initial bipartitioner, and so does the port."""
    monkeypatch.delenv("KAMINPAR_TPU_NO_NATIVE_IP", raising=False)
    make, k = CASES[case]
    host = make()
    jax.clear_caches()
    before = native.ml_bipartition.calls
    jpart, tpart = run_both(host, k, device_bipartition_threshold=64)
    assert native.ml_bipartition.calls > before
    np.testing.assert_array_equal(jpart, tpart)


def test_isolated_nodes_and_tiny_graphs():
    """Isolated-node removal and reintegration, an all-isolated graph and
    k=1 through the facade (the port alone: the outputs are checked
    against the strict caps)."""
    g = kp.make_rmat(1 << 9, 600, seed=2)  # many isolated nodes
    for k in (1, 3, 8):
        part = kp.KaMinPar("default", device="cpu").set_graph(
            g).compute_partition(k=k, epsilon=0.03, seed=4)
        bw = np.bincount(part, minlength=k)
        assert part.shape == (g.n,) and part.max() < k
        assert bw.max() <= int(np.ceil(1.03 * np.ceil(g.n / k)))
    iso = kp.HostGraph(np.zeros(51, dtype=np.int64),
                       np.zeros(0, dtype=np.int32))
    part = kp.KaMinPar("default", device="cpu").set_graph(
        iso).compute_partition(k=4, epsilon=0.03, seed=1)
    assert np.bincount(part, minlength=4).max() <= 14
