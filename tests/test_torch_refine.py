"""Parity of the port's refinement (Jet, the balancers) and metrics with
the JAX package's, at zero tolerance.

Inputs are made with numpy from seeds; both packages get the same padded
level and starting partition.  Jet runs with and without its incremental
machinery (the size threshold lowered in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu.ops.jet as jjet
import kaminpar_tpu_torch.ops.jet as tjet
from kaminpar_tpu.context import JetRefinementContext as JJetCtx
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.ops import balancer as jbal
from kaminpar_tpu.ops import metrics as jmetrics
from kaminpar_tpu_torch.context import JetRefinementContext as TJetCtx
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from kaminpar_tpu_torch.ops import balancer as tbal
from kaminpar_tpu_torch.ops import metrics as tmetrics
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


# ----------------------------------------------------------------- Jet


@pytest.mark.parametrize("k,level", [(2, 0), (4, 1), (16, 0)])
def test_jet_refine(graphs, k, level):
    jg, tg = graphs
    part = _random_partition(tg, k, 100 + k)
    caps = _caps(tg, k, 1.03)
    same(
        jjet.jet_refine(jg, jnp.asarray(part), k, jnp.asarray(caps),
                        jnp.int32(4), JJetCtx(), level, 2),
        tjet.jet_refine(tg, tt(part), k, tt(caps), 4, TJetCtx(), level, 2),
    )


@pytest.mark.parametrize("k", [2, 8])
def test_jet_refine_incremental(graphs, k, monkeypatch, fresh_jit):
    """Delta budget m_pad / 4 with candidate pruning and the incremental
    conn table, in both packages."""
    jg, tg = graphs
    for mod in (jjet, tjet):
        monkeypatch.setattr(mod, "DELTA_MIN_EDGE_SLOTS", 1)
    part = _random_partition(tg, k, 7 * k)
    caps = _caps(tg, k, 1.03)
    same(
        jjet.jet_refine(jg, jnp.asarray(part), k, jnp.asarray(caps),
                        jnp.int32(9), JJetCtx(), 1, 3),
        tjet.jet_refine(tg, tt(part), k, tt(caps), 9, TJetCtx(), 1, 3),
    )


# ----------------------------------------------------------- balancers


def _skewed_partition(tg, k, seed):
    """Most weight in block 0: overloaded and underloaded blocks."""
    rng = np.random.default_rng(seed)
    part = np.zeros(tg.n_pad, np.int32)
    part[: tg.n] = np.where(rng.random(tg.n) < 0.6, 0,
                            rng.integers(0, k, tg.n))
    return part


@pytest.mark.parametrize("k", [2, 8, 300])
def test_overload_balance(graphs, k):
    jg, tg = graphs
    part = _skewed_partition(tg, k, k)
    caps = _caps(tg, k, 1.03)
    same(
        jbal.overload_balance(jg, jnp.asarray(part), k, jnp.asarray(caps),
                              jnp.int32(5)),
        tbal.overload_balance(tg, tt(part), k, tt(caps), 5),
    )


@pytest.mark.parametrize("k", [4, 300])
def test_underload_balance(graphs, k):
    jg, tg = graphs
    part = _skewed_partition(tg, k, k + 1)
    caps = _caps(tg, k, 1.5)
    mins = (_caps(tg, k, 1.0) * 0.9).astype(np.int32)
    same(
        jbal.underload_balance(jg, jnp.asarray(part), k, jnp.asarray(caps),
                               jnp.asarray(mins), jnp.int32(6)),
        tbal.underload_balance(tg, tt(part), k, tt(caps), tt(mins), 6),
    )


def test_host_balance(graphs):
    jg, tg = graphs
    n = tg.n
    k = 4
    part = _skewed_partition(tg, k, 3)[:n]
    node_w = np.asarray(jg.node_w)[:n].astype(np.int64)
    xadj = np.asarray(jg.row_ptr)[: n + 1].astype(np.int64)
    m = int(jg.m)
    adj = (xadj, np.asarray(jg.dst)[:m],
           np.asarray(jg.edge_w)[:m].astype(np.int64))
    caps = _caps(tg, k, 1.03).astype(np.int64)
    a = jbal.host_balance(node_w, adj, part, caps)
    b = tbal.host_balance(node_w, adj, part, caps)
    np.testing.assert_array_equal(a, b)
    assert (np.bincount(b, node_w, k) <= caps).all()


# ------------------------------------------------------------- metrics


@pytest.mark.parametrize("k", [2, 16])
def test_metrics(graphs, k):
    jg, tg = graphs
    part = _random_partition(tg, k, 55)
    caps = _caps(tg, k, 1.01)
    mins = (caps * 0.8).astype(np.int32)
    same(jmetrics.block_weights(jg, jnp.asarray(part), k),
         tmetrics.block_weights(tg, tt(part), k))
    same(jmetrics.edge_cut(jg, jnp.asarray(part)),
         tmetrics.edge_cut(tg, tt(part)))
    same(jmetrics.total_overload(jg, jnp.asarray(part), jnp.asarray(caps)),
         tmetrics.total_overload(tg, tt(part), tt(caps)))
    for m in (None, mins):
        same(
            jmetrics.is_feasible(jg, jnp.asarray(part), jnp.asarray(caps),
                                 None if m is None else jnp.asarray(m)),
            tmetrics.is_feasible(tg, tt(part), tt(caps),
                                 None if m is None else tt(m)),
        )
