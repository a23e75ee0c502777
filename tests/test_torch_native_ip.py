"""The port's native initial bipartitioner (kaminpar_tpu_torch/native/,
its own copy of ip.cpp) against the JAX package's (kaminpar_tpu.native),
bitwise: the same graph, caps, context and seed give the same int8
partition.  Also the choice of path: native unless
KAMINPAR_TPU_NO_NATIVE_IP=1, the seed drawn only on the native path, and
a failed build raises.
"""

import numpy as np
import pytest

import kaminpar_tpu.native as jnative
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch import native
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.initial import InitialMultilevelBipartitioner
from kaminpar_tpu_torch.presets import create_context_by_preset_name
from torch_threads import one_torch_thread  # noqa: F401


def _weighted(g, seed):
    """`g` with node weights in [1, 20] and symmetric edge weights in
    [1, 9], as a coarse level carries them."""
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    edge_w = (lo * 7 + hi * 13) % 9 + 1
    node_w = np.random.default_rng(seed).integers(1, 21, g.n)
    return JaxHostGraph(g.xadj, g.adjncy, node_w, edge_w)


def _two_parts_and_isolated():
    """Two R-MAT components side by side, with many isolated nodes."""
    a = jfactories.make_rmat(1 << 9, 600, seed=2)
    b = jfactories.make_rmat(1 << 8, 1500, seed=6)
    xadj = np.concatenate([a.xadj, a.xadj[-1] + b.xadj[1:]])
    adjncy = np.concatenate([a.adjncy, b.adjncy + a.n]).astype(np.int32)
    return JaxHostGraph(xadj, adjncy)


GRAPHS = {
    "weighted-coarse": lambda: _weighted(
        jfactories.make_rmat(1 << 11, 16_000, seed=4), 4),
    "rmat": lambda: jfactories.make_rmat(1 << 12, 30_000, seed=3),
    "rgg": lambda: jfactories.make_rgg2d(1 << 12, seed=1),
    "isolated-parts": _two_parts_and_isolated,
    "n1": lambda: JaxHostGraph(np.zeros(2, dtype=np.int64),
                               np.zeros(0, dtype=np.int32)),
}


def _port_graph(g):
    return HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [1, 2**62 - 3])
def test_ml_bipartition_matches_the_jax_package(name, seed):
    g = GRAPHS[name]()
    total = int(g.node_weight_array().sum())
    max_bw = np.array([(total + 1) // 2 * 103 // 100,
                       total // 2 * 103 // 100 + 1], dtype=np.int64)
    assert jnative.available()
    jpart = jnative.ml_bipartition(
        g, max_bw, jax_preset("default").initial_partitioning, seed
    )
    before = native.ml_bipartition.calls
    tpart = native.ml_bipartition(
        _port_graph(g), max_bw,
        create_context_by_preset_name("default").initial_partitioning, seed,
    )
    assert native.ml_bipartition.calls == before + 1
    assert tpart.dtype == np.int8 and tpart.shape == (g.n,)
    np.testing.assert_array_equal(jpart, tpart)


def test_ip_source_is_the_jax_packages_file():
    jax_src = jnative._DIR + "/ip.cpp"
    with open(jax_src, "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


@pytest.mark.parametrize("switched_off", [False, True])
def test_path_choice_and_rng_stream(switched_off, monkeypatch):
    """Native by default; the env var selects the numpy path, which then
    draws no seed first (the JAX package's order of draws)."""
    if switched_off:
        monkeypatch.setenv(native.NO_NATIVE_IP_ENV, "1")
    else:
        monkeypatch.delenv(native.NO_NATIVE_IP_ENV, raising=False)
    g = _port_graph(jfactories.make_rmat(1 << 10, 6000, seed=8))
    ctx = create_context_by_preset_name("default").initial_partitioning
    max_bw = np.array([g.n // 2 + 20, g.n // 2 + 20], dtype=np.int64)
    rng = np.random.default_rng(5)
    before = native.ml_bipartition.calls
    part = InitialMultilevelBipartitioner(ctx).bipartition(g, max_bw, rng)
    assert native.enabled() is not switched_off
    assert native.ml_bipartition.calls == before + (not switched_off)
    assert part.dtype == np.int8 and part.shape == (g.n,)
    assert np.bincount(part, minlength=2).max() <= max_bw[0]
    if not switched_off:
        expect = native.ml_bipartition(
            g, max_bw, ctx, int(np.random.default_rng(5).integers(0, 2**62))
        )
        np.testing.assert_array_equal(part, expect)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ip.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
