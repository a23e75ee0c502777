"""The port's k-way FM against the JAX package's, bitwise: the native
localized batch FM (kaminpar_tpu_torch/native/fm.cpp, its own copy of the
JAX package's fm.cpp) on its dense and sparse gain tables, the host FM
refiner on both of its paths (native by default, numpy under
KAMINPAR_TPU_NO_NATIVE_FM=1), and the gain caches of
refinement/gains.py, host and device.  Tolerance zero: FM is integer
arithmetic with seeded tie-breaks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu.native as jnative
from kaminpar_tpu.context import FMRefinementContext as JaxFMContext
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.refinement import fm as jfm
from kaminpar_tpu.refinement import gains as jgains
from kaminpar_tpu_torch import native
from kaminpar_tpu_torch.context import FMRefinementContext
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.refinement import fm as tfm
from kaminpar_tpu_torch.refinement import gains as tgains
from torch_threads import one_torch_thread  # noqa: F401


def _weighted(g, seed):
    """`g` with node weights in [1, 5] and symmetric edge weights in
    [1, 9], as a coarse level carries them."""
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    edge_w = (lo * 7 + hi * 13) % 9 + 1
    node_w = np.random.default_rng(seed).integers(1, 6, g.n)
    return JaxHostGraph(g.xadj, g.adjncy, node_w, edge_w)


@pytest.fixture(scope="module")
def graph():
    return _weighted(jfactories.make_rmat(1 << 11, 16_000, seed=4), 4)


def _port_graph(g):
    return HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)


def _case(g, k, seed):
    """A feasible start partition (blocks by node id, then a tenth of the
    nodes moved at random) and caps with 5% slack."""
    rng = np.random.default_rng(seed)
    part = (np.arange(g.n) * k // g.n).astype(np.int32)
    moved = rng.random(g.n) < 0.1
    part[moved] = rng.integers(0, k, int(moved.sum()))
    total = int(g.node_weight_array().sum())
    caps = np.full(k, int(1.05 * total / k) + 5, dtype=np.int64)
    bw = np.bincount(part, weights=g.node_weight_array(), minlength=k)
    caps = np.maximum(caps, bw.astype(np.int64))
    return part, caps


def _upload(g):
    """The same padded device graph in both packages."""
    jg = jax_upload(g)
    return jg, device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device="cpu",
    )


def _cut(g, part):
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    return int(g.edge_weight_array()[part[src] != part[g.adjncy]].sum()) // 2


@pytest.mark.parametrize("force_sparse", [False, True])
@pytest.mark.parametrize("k", [2, 8, 64])
def test_native_fm_matches_the_jax_package(graph, k, force_sparse):
    part, caps = _case(graph, k, k)
    jpart, tpart = part.copy(), part.copy()
    jctx, tctx = JaxFMContext(), FMRefinementContext()
    jgain = jnative.fm_refine(graph, jpart, k, caps, jctx, 17,
                              force_sparse=force_sparse)
    before = native.fm_refine.calls
    tgain = native.fm_refine(_port_graph(graph), tpart, k, caps, tctx, 17,
                             force_sparse=force_sparse)
    assert native.fm_refine.calls == before + 1
    assert tgain == jgain > 0
    np.testing.assert_array_equal(jpart, tpart)
    assert _cut(graph, part) - _cut(graph, tpart) == tgain
    assert (np.bincount(tpart, weights=graph.node_weight_array(),
                        minlength=k) <= caps).all()


def test_native_fm_refusal_leaves_the_partition():
    """k beyond the sparse engine's 16-bit block tags: FM_REFUSED
    (INT64_MIN), as in the JAX package, and no node moves."""
    g = jfactories.make_rmat(1 << 8, 900, seed=1)
    k = 0x10000
    part = np.arange(g.n, dtype=np.int32)
    caps = np.full(k, 4, dtype=np.int64)
    tpart = part.copy()
    assert native.FM_REFUSED == jnative.FM_REFUSED == -(1 << 63)
    assert native.fm_refine(_port_graph(g), tpart, k, caps,
                            FMRefinementContext(), 3,
                            force_sparse=True) == native.FM_REFUSED
    np.testing.assert_array_equal(tpart, part)


def test_fm_source_is_the_jax_packages_file():
    with open(jnative._DIR + "/fm.cpp", "rb") as f:
        assert native.FM_SOURCE.read_bytes() == f.read()


def test_failed_fm_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fm.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "FM_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_fm_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.fm_refine(HostGraph(np.array([0, 1, 2]), np.array([1, 0])),
                         np.zeros(2, dtype=np.int32), 2,
                         np.array([2, 2]), FMRefinementContext(), 1)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("k", [2, 8])
def test_fm_refine_host_matches_the_jax_package(graph, k, path,
                                                monkeypatch):
    """The refiner as the pipeline calls it: a padded device partition in,
    a padded device partition out, on the native path and under
    KAMINPAR_TPU_NO_NATIVE_FM=1 on the numpy FM in both packages."""
    if path == "numpy":
        monkeypatch.setenv(native.NO_NATIVE_FM_ENV, "1")
    else:
        monkeypatch.delenv(native.NO_NATIVE_FM_ENV, raising=False)
    part, caps = _case(graph, k, 5 * k)
    jg, tg = _upload(graph)
    padded = np.zeros(tg.n_pad, dtype=np.int32)
    padded[: graph.n] = part
    ctx = FMRefinementContext(num_iterations=2)
    before = native.fm_refine.calls
    jout = np.asarray(jfm.fm_refine_host(
        jg, jnp.asarray(padded), k, jnp.asarray(caps.astype(np.int32)),
        JaxFMContext(num_iterations=2), seed=9,
    ))
    tout = tfm.fm_refine_host(
        tg, torch.from_numpy(padded), k,
        torch.from_numpy(caps.astype(np.int32)), ctx, seed=9,
    )
    assert native.fm_refine.calls == before + (path == "native")
    assert tout.dtype == torch.int32 and tout.shape == (tg.n_pad,)
    np.testing.assert_array_equal(jout, tout.numpy())
    assert _cut(graph, tout.numpy()[: graph.n]) < _cut(graph, part)


# -------------------------------------------------------------- gain caches


def _moves(g, k, count, seed):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, g.n, count).tolist(),
                    rng.integers(0, k, count).tolist()))


@pytest.mark.parametrize("k", [2, 8])
def test_host_gain_caches_match_the_jax_package(graph, k):
    """The dense and on-the-fly host caches give the JAX package's best
    moves and gains along one move sequence, and the delta overlay its
    speculative gains before and after commit."""
    part, caps = _case(graph, k, k + 1)
    tgraph = _port_graph(graph)
    node_w = graph.node_weight_array()
    bw = np.bincount(part, weights=node_w, minlength=k).astype(np.int64)
    caches = [
        (jgains.HostDenseGainCache(graph, part, k),
         tgains.HostDenseGainCache(tgraph, part, k)),
        (jgains.HostOnTheFlyGainCache(graph, part, k),
         tgains.HostOnTheFlyGainCache(tgraph, part, k)),
    ]
    np.testing.assert_array_equal(caches[0][0].conn, caches[0][1].conn)
    for u, t in _moves(graph, k, 200, k):
        for jc, tc in caches:
            assert jc.best_move(u, part, node_w, bw, caps) == tc.best_move(
                u, part, node_w, bw, caps)
        b = int(part[u])
        if b == t:
            continue
        part[u] = t
        bw[b] -= node_w[u]
        bw[t] += node_w[u]
        for jc, tc in caches:
            jc.apply_move(u, b, t)
            tc.apply_move(u, b, t)
    np.testing.assert_array_equal(caches[0][0].conn, caches[0][1].conn)
    np.testing.assert_array_equal(
        caches[0][1].conn, tgains.HostDenseGainCache(tgraph, part, k).conn)

    jd = jgains.HostDeltaGainCache(caches[0][0])
    td = tgains.HostDeltaGainCache(caches[0][1])
    for u, t in _moves(graph, k, 30, 7 * k):
        b = int(part[u])
        jd.apply_move(u, b, t)
        td.apply_move(u, b, t)
        for v in graph.adjncy[graph.xadj[u]:graph.xadj[u + 1]][:5]:
            assert jd.gain(int(v), b, t) == td.gain(int(v), b, t)
    jd.commit()
    td.commit()
    np.testing.assert_array_equal(caches[0][0].conn, caches[0][1].conn)


def test_host_gain_cache_choice(graph, monkeypatch):
    part = np.zeros(graph.n, dtype=np.int32)
    tgraph = _port_graph(graph)
    assert isinstance(tgains.create_host_gain_cache(tgraph, part, 4),
                      tgains.HostDenseGainCache)
    monkeypatch.setattr(tgains, "DENSE_CACHE_MAX_ENTRIES", graph.n)
    monkeypatch.setattr(jgains, "DENSE_CACHE_MAX_ENTRIES", graph.n)
    for mod, g in ((tgains, tgraph), (jgains, graph)):
        assert isinstance(mod.create_host_gain_cache(g, part, 4),
                          mod.HostOnTheFlyGainCache)


@pytest.mark.parametrize("k", [2, 8, 64])
def test_device_gain_functions_match_the_jax_package(graph, k):
    """build_dense_gain_cache, update_dense_gain_cache after a move round,
    best_moves_from_cache under the caps (some rows with no feasible
    target) and on_the_fly_gains, as plain torch ops."""
    jg, tg = _upload(graph)
    part, caps = _case(graph, k, 3 * k)
    old = np.zeros(tg.n_pad, dtype=np.int32)
    old[: graph.n] = part
    new = old.copy()
    moved = np.random.default_rng(k).random(graph.n) < 0.2
    new[: graph.n][moved] = (part[moved] + 1) % k
    j, t = jnp.asarray, torch.from_numpy

    jconn = jgains.build_dense_gain_cache(jg, j(old), k)
    tconn = tgains.build_dense_gain_cache(tg, t(old), k)
    np.testing.assert_array_equal(np.asarray(jconn), tconn.numpy())
    jconn = jgains.update_dense_gain_cache(jconn, jg, j(old), j(new), k)
    tconn2 = tgains.update_dense_gain_cache(tconn, tg, t(old), t(new), k)
    np.testing.assert_array_equal(np.asarray(jconn), tconn2.numpy())
    np.testing.assert_array_equal(
        tconn2.numpy(), tgains.build_dense_gain_cache(tg, t(new), k).numpy())

    bw = np.bincount(new, weights=np.asarray(jg.node_w), minlength=k)
    bw = bw.astype(np.int32)
    # every block but block 0 full: only block 0 takes nodes, and the
    # nodes in it have no target
    tight = bw.copy()
    tight[0] = caps[0]
    args = (j(new), jg.node_w, j(bw), j(tight))
    jbest, jgain = jgains.best_moves_from_cache(jconn, *args, k=k)
    tbest, tgain = tgains.best_moves_from_cache(
        tconn2, t(new), tg.node_w, t(bw), t(tight), k)
    np.testing.assert_array_equal(np.asarray(jbest), tbest.numpy())
    np.testing.assert_array_equal(np.asarray(jgain), tgain.numpy())
    best = tbest.numpy()[: graph.n]
    assert (best[new[: graph.n] == 0] == -1).all()
    assert (best[new[: graph.n] != 0] == 0).all()

    for a, b in zip(jgains.on_the_fly_gains(jg, j(new), k),
                    tgains.on_the_fly_gains(tg, t(new), k)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_mtkahypar_refiner_raises_without_the_package(graph):
    """The gated Mt-KaHyPar adapter: without the external `mtkahypar`
    package (installed nowhere this repo runs) both packages' adapters
    raise, and so does the port's refiner pipeline when the context
    selects it (no quiet rollback)."""
    from kaminpar_tpu.refinement.mtkahypar import (
        mtkahypar_refine_host as jax_mtk,
    )
    from kaminpar_tpu_torch.context import Context, RefinementAlgorithm
    from kaminpar_tpu_torch.partitioning.refiner import RefinerPipeline
    from kaminpar_tpu_torch.refinement.mtkahypar import mtkahypar_refine_host

    part, caps = _case(graph, 4, 1)
    for fn, g in ((jax_mtk, graph), (mtkahypar_refine_host,
                                     _port_graph(graph))):
        with pytest.raises(RuntimeError, match="mtkahypar package"):
            fn(g, part, 4, caps)
    ctx = Context()
    ctx.refinement.algorithms = [RefinementAlgorithm.MTKAHYPAR]
    _, tg = _upload(graph)
    padded = torch.zeros(tg.n_pad, dtype=torch.int32)
    padded[: graph.n] = torch.from_numpy(part)
    with pytest.raises(RuntimeError, match="mtkahypar package"):
        RefinerPipeline(ctx, 4).refine(
            tg, padded, torch.from_numpy(caps.astype(np.int32)), None,
            seed=1)
