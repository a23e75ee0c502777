"""Parity of the port's label propagation (kaminpar_tpu_torch/ops/lp.py)
with the JAX package's, at zero tolerance.

Inputs are made with numpy from seeds; both packages get the same padded
level.  lp_cluster runs under every rating engine the path can pick
(forced through `LPConfig.rating`) and with delta rounds (the size
threshold lowered in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu.ops.lp as jlp
import kaminpar_tpu_torch.ops.lp as tlp
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from torch_threads import one_torch_thread  # noqa: F401


def tt(a):
    return torch.from_numpy(np.array(a))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def port_graph(jg):
    return device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device="cpu",
    )


def _weighted_rmat(n, m, seed):
    g = jfactories.make_rmat(n, m, seed=seed)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    edge_w = (lo * 7 + hi * 13) % 3 + 1
    node_w = np.random.default_rng(seed).integers(1, 5, g.n)
    return JaxHostGraph(g.xadj, g.adjncy, node_w, edge_w)


GRAPHS = {
    # skewed, weighted, with isolated nodes
    "rmat": lambda: _weighted_rmat(1 << 10, 8000, seed=5),
    # uniform degrees, unit weights (many ties)
    "rgg": lambda: jfactories.make_rgg2d(1 << 10, seed=2),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    jg = jax_upload(GRAPHS[request.param]())
    return jg, port_graph(jg)


@pytest.fixture
def fresh_jit():
    """Thresholds are read when the JAX programs are traced: drop cached
    executables around a test that lowers one."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _random_partition(tg, k, seed):
    part = np.zeros(tg.n_pad, np.int32)
    part[: tg.n] = np.random.default_rng(seed).integers(0, k, tg.n)
    return part


def _caps(tg, k, slack):
    total = int(tg.node_w.sum())
    return np.full(k, int(np.ceil(total / k * slack)), np.int32)


# ------------------------------------------------------------------ LP


@pytest.mark.parametrize("engine", ["sort2", "scatter", "dense", "hash",
                                    "sort"])
def test_lp_cluster_per_engine(graphs, engine):
    jg, tg = graphs
    jcfg = jlp.LPConfig(rating=engine)
    tcfg = tlp.LPConfig(rating=engine)
    jl = jlp.lp_cluster(jg, jnp.int32(12), jnp.int32(3), jcfg)
    tl = tlp.lp_cluster(tg, 12, 3, tcfg)
    same(jl, tl)


@pytest.mark.parametrize("budget", ["quarter", "full"])
@pytest.mark.parametrize("engine", ["sort2", "scatter", "dense"])
def test_lp_cluster_delta_rounds(graphs, engine, budget, request,
                                 monkeypatch, fresh_jit):
    """Delta rounds over the compacted active rows: at the path's m_pad / 4
    buffer (reached late, once the active set has shrunk) and at a
    full-width buffer (every round after the first)."""
    jg, tg = graphs
    for mod in (jlp, tlp):
        monkeypatch.setattr(mod, "DELTA_MIN_EDGE_SLOTS", 1)
        if budget == "full":
            real_slots = mod._delta_slots
            monkeypatch.setattr(
                mod, "_delta_slots",
                lambda g, cfg, eng, real=real_slots: (
                    None if real(g, cfg, eng) is None else g.src.shape[0]
                ),
            )
    calls = []
    real_round = tlp.lp_round

    def spy(*args, **kwargs):
        calls.append(kwargs.get("rows") is not None)
        return real_round(*args, **kwargs)

    monkeypatch.setattr(tlp, "lp_round", spy)
    cfg = dict(rating=engine, num_iterations=20, participation=0.5)
    jl = jlp.lp_cluster(jg, jnp.int32(12), jnp.int32(7),
                        jlp.LPConfig(**cfg))
    tl = tlp.lp_cluster(tg, 12, 7, tlp.LPConfig(**cfg))
    same(jl, tl)
    # the skewed graph's tie moves keep most rows active: only the
    # uniform graph shrinks below the quarter buffer within 20 rounds
    if budget == "full" or request.node.callspec.params["graphs"] == "rgg":
        assert any(calls), "no delta round ran"


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("delta", [False, True])
def test_lp_refine(graphs, k, delta, monkeypatch, fresh_jit):
    jg, tg = graphs
    if delta:
        for mod in (jlp, tlp):
            monkeypatch.setattr(mod, "DELTA_MIN_EDGE_SLOTS", 1)
    part = _random_partition(tg, k, k)
    caps = _caps(tg, k, 1.05)
    same(
        jlp.lp_refine(jg, jnp.asarray(part), k, jnp.asarray(caps),
                      jnp.int32(2)),
        tlp.lp_refine(tg, tt(part), k, tt(caps), 2),
    )


@pytest.mark.parametrize("engine", ["scatter", "sort2", "hash", "sort"])
def test_post_passes(graphs, engine):
    """Isolated-node clustering and two-hop clustering from a partially
    clustered state (half the nodes merged in pairs)."""
    jg, tg = graphs
    n_pad = tg.n_pad
    labels = np.arange(n_pad, dtype=np.int32)
    half = np.arange(0, tg.n - 1, 4)
    labels[half + 1] = half
    node_w = np.asarray(jg.node_w)
    cw = np.bincount(labels, node_w, n_pad).astype(np.int32)
    mcw = 9
    same(
        jlp.cluster_isolated_nodes(jg, jnp.asarray(labels), jnp.asarray(cw),
                                   jnp.int32(mcw))[0],
        tlp.cluster_isolated_nodes(tg, tt(labels), tt(cw),
                                   torch.tensor(mcw, dtype=torch.int32))[0],
    )
    jout = jlp.two_hop_cluster(jg, jnp.asarray(labels), jnp.asarray(cw),
                               jnp.int32(mcw), jnp.int32(11),
                               jlp.LPConfig(rating=engine))
    tout = tlp.two_hop_cluster(tg, tt(labels), tt(cw),
                               torch.tensor(mcw, dtype=torch.int32), 11,
                               tlp.LPConfig(rating=engine))
    for a, b in zip(jout, tout):
        same(a, b)
