"""Parity of the port's coarsening (contraction, the Coarsener hierarchy),
block extraction and host initial partitioning with the JAX package's,
at zero tolerance.

The hierarchy check runs both coarseners level by level on the same
graph and context and compares (n, m, cmap) and the coarse arrays at
every level, then projects one partition back up through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.initial import InitialMultilevelBipartitioner as JIP
from kaminpar_tpu.ops import contraction as jcon
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.ops import subgraphs as jsub
from kaminpar_tpu.partitioning import coarsener as jcoarsener
from kaminpar_tpu.partitioning import deep as jdeep
from kaminpar_tpu.partitioning import rb as jrb
from kaminpar_tpu.presets import create_context_by_preset_name as jctx_of
from kaminpar_tpu.utils import rng as jrng
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from kaminpar_tpu_torch.graphs.host import HostGraph as TorchHostGraph
from kaminpar_tpu_torch.initial import InitialMultilevelBipartitioner as TIP
from kaminpar_tpu_torch.ops import contraction as tcon
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops import subgraphs as tsub
from kaminpar_tpu_torch.partitioning import coarsener as tcoarsener
from kaminpar_tpu_torch.partitioning import deep as tdeep
from kaminpar_tpu_torch.partitioning import rb as trb
from kaminpar_tpu_torch.presets import create_context_by_preset_name as tctx_of
from kaminpar_tpu_torch.utils import rng as trng
from torch_threads import one_torch_thread  # noqa: F401

GRAPH_FIELDS = ("row_ptr", "src", "dst", "edge_w", "node_w")


def tt(a):
    return torch.from_numpy(np.array(a))


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def same_graph(jg, tg):
    assert (int(jg.n), int(jg.m)) == (tg.n, tg.m)
    for f in GRAPH_FIELDS:
        same(getattr(jg, f), getattr(tg, f))


def port_graph(jg):
    return device_graph_from_arrays(
        *(np.asarray(getattr(jg, f)) for f in GRAPH_FIELDS),
        int(jg.n), int(jg.m), device="cpu",
    )


def torch_host(g):
    return TorchHostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)


def _weighted_rmat(n, m, seed):
    g = jfactories.make_rmat(n, m, seed=seed)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    edge_w = (lo * 7 + hi * 13) % 3 + 1
    node_w = np.random.default_rng(seed).integers(1, 5, g.n)
    return JaxHostGraph(g.xadj, g.adjncy, node_w, edge_w)


GRAPHS = {
    "rmat": lambda: jfactories.make_rmat(1 << 11, 16_000, seed=3),
    "rmat-weighted": lambda: _weighted_rmat(1 << 10, 8000, seed=5),
    "rgg": lambda: jfactories.make_rgg2d(1 << 11, seed=1),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def host_graph(request):
    return GRAPHS[request.param]()


@pytest.mark.parametrize("labels_from", ["lp", "random"])
def test_contract_clustering(host_graph, labels_from):
    jg = jax_upload(host_graph)
    tg = port_graph(jg)
    if labels_from == "lp":
        labels = np.asarray(jlp.lp_cluster(jg, jnp.int32(10), jnp.int32(1)))
        same(labels, tlp.lp_cluster(tg, 10, 1))
    else:  # groups of random size, pad slots keep their own id
        rng = np.random.default_rng(4)
        labels = np.arange(tg.n_pad, dtype=np.int32)
        labels[: tg.n] = rng.integers(0, max(tg.n // 3, 1), tg.n)
    jcoarse, jcn, jcm = jcon.contract_clustering(jg, jnp.asarray(labels))
    tcoarse, tcn, tcm = tcon.contract_clustering(tg, tt(labels))
    assert (jcn, jcm) == (tcn, tcm)
    same(jcoarse.cmap, tcoarse.cmap)
    same_graph(jcoarse.graph, tcoarse.graph)
    part = np.random.default_rng(5).integers(
        0, 4, tcoarse.graph.n_pad
    ).astype(np.int32)
    same(jcoarse.project_up(jnp.asarray(part)),
         tcoarse.project_up(tt(part)))


@pytest.mark.parametrize("limit", [40, 160])
def test_coarsening_hierarchy(host_graph, limit):
    """Same (n, m, cmap) and coarse graph per level, and the same
    projection of a partition back to the input level."""
    jctx, tctx = jctx_of("default"), tctx_of("default")
    for ctx, g in ((jctx, host_graph), (tctx, torch_host(host_graph))):
        ctx.partition.setup(g, k=8, epsilon=0.03)
        ctx.coarsening.contraction_limit = limit
    jg = jax_upload(host_graph)
    tg = port_graph(jg)
    jc = jcoarsener.Coarsener(jctx, jg, host_graph.n)
    tc = tcoarsener.Coarsener(tctx, tg, host_graph.n)
    threshold = 2 * limit
    levels = 0
    while tc.current_n > threshold:
        went_on = tc.coarsen()
        assert jc.coarsen() == went_on
        if not went_on:
            break
        jl, tl = jc.levels[-1], tc.levels[-1]
        assert (jl.fine_n, jl.coarse_n, jl.coarse_m) == (
            tl.fine_n, tl.coarse_n, tl.coarse_m
        )
        same(jl.coarse.cmap, tl.coarse.cmap)
        same_graph(jl.coarse.graph, tl.coarse.graph)
        levels += 1
    assert levels >= 2
    assert jc.current_n == tc.current_n
    part = np.random.default_rng(levels).integers(
        0, 8, tc.current.n_pad
    ).astype(np.int32)
    jpart, tpart = jnp.asarray(part), tt(part)
    while not tc.empty():
        _, jpart = jc.uncoarsen(jpart)
        _, tpart = tc.uncoarsen(tpart)
        same(jpart, tpart)
    assert jc.empty()


@pytest.mark.parametrize("k", [2, 4, 7])
def test_block_extraction_and_assembly(host_graph, k):
    jg = jax_upload(host_graph)
    tg = port_graph(jg)
    rng = np.random.default_rng(k)
    part = np.zeros(tg.n_pad, np.int32)
    part[: tg.n] = rng.integers(0, k, tg.n)
    jext = jsub.extract_blocks_device(jg, jnp.asarray(part), k)
    text = tsub.extract_blocks_device(tg, tt(part), k)
    for field in jext._fields:
        a, b = getattr(jext, field), getattr(text, field)
        if isinstance(b, torch.Tensor):
            same(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bp_j = jnp.zeros(tg.n_pad, jnp.int32)
    bp_t = torch.zeros(tg.n_pad, dtype=torch.int32)
    for block in range(k):
        jsub_g, jn, jm = jsub.slice_block(jext, block, 256, 256)
        tsub_g, tn, tm = tsub.slice_block(text, block, 256, 256)
        assert (jn, jm) == (tn, tm)
        same_graph(jsub_g, tsub_g)
        jh = jsub.host_graph_from_padded(jsub_g, jn, jm)
        th = tsub.host_graph_from_padded(tsub_g, tn, tm)
        for f in ("xadj", "adjncy", "node_weights", "edge_weights"):
            np.testing.assert_array_equal(getattr(jh, f), getattr(th, f))
        bp = rng.integers(0, 2, tsub_g.n_pad).astype(np.int32)
        start = int(np.asarray(jext.node_start)[block])
        bp_j = jsub.scatter_block_bipartition(
            bp_j, jnp.asarray(bp), jnp.int32(start), jnp.int32(jn),
            jsub_g.n_pad,
        )
        bp_t = tsub.scatter_block_bipartition(bp_t, tt(bp), start, tn,
                                              tsub_g.n_pad)
        same(bp_j, bp_t)
    base = np.cumsum([0] + [2] * (k - 1)).astype(np.int32)
    is_split = rng.random(k) < 0.7
    same(
        jsub.assemble_extended_partition(
            jext.b, jext.new_id, jext.node_start, bp_j, jnp.asarray(base),
            jnp.asarray(is_split), k,
        ),
        tsub.assemble_extended_partition(
            text.b, text.new_id, text.node_start, bp_t, tt(base),
            tt(is_split), k,
        ),
    )


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_initial_bipartitioner(host_graph, seed, monkeypatch):
    """The host multilevel bipartitioner (numpy path on both sides) with
    generators derived alike."""
    monkeypatch.setenv("KAMINPAR_TPU_NO_NATIVE_IP", "1")
    jctx, tctx = jctx_of("default"), tctx_of("default")
    for ctx, g in ((jctx, host_graph), (tctx, torch_host(host_graph))):
        ctx.partition.setup(g, k=4, epsilon=0.03)
    total = int(host_graph.node_weight_array().sum())
    max_w = jrb.bipartition_max_block_weights(jctx, 0, 4, total)
    np.testing.assert_array_equal(
        max_w, trb.bipartition_max_block_weights(tctx, 0, 4, total)
    )
    jrng.set_seed(seed)
    a = JIP(jctx.initial_partitioning).bipartition(
        host_graph, max_w, jrng.host_rng(seed ^ 0xDEE9)
    )
    b = TIP(tctx.initial_partitioning).bipartition(
        torch_host(host_graph), max_w, trng.host_rng(seed, seed ^ 0xDEE9)
    )
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 13, 64])
def test_k_helpers(k):
    assert jrb.split_k(k) == trb.split_k(k)
    jctx, tctx = jctx_of("default"), tctx_of("default")
    for n in (10, 200, 5000, 100_000):
        jctx.partition.k = tctx.partition.k = k
        assert jdeep.compute_k_for_n(n, jctx) == tdeep.compute_k_for_n(
            n, tctx
        )
