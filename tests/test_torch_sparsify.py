"""Parity of the linear-time-kway pieces with the JAX package's, at zero
tolerance: the edge sparsifier (ops/sparsify.py: the int32-wrapping pair
key, the float32 threshold, half-to-even rounding of the rescaled
weights), the Coarsener under SPARSIFICATION_CLUSTERING on a graph above
its 2^16-edge floor, level by level, and the v-cycle's project_down.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.context import CoarseningAlgorithm as JaxAlgorithm
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.ops import contraction as jcon
from kaminpar_tpu.ops import sparsify as jsparsify
from kaminpar_tpu.partitioning import coarsener as jcoarsener
from kaminpar_tpu.presets import create_context_by_preset_name as jctx_of
from kaminpar_tpu_torch.context import CoarseningAlgorithm
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.ops import contraction as tcon
from kaminpar_tpu_torch.ops import sparsify as tsparsify
from kaminpar_tpu_torch.partitioning import coarsener as tcoarsener
from kaminpar_tpu_torch.presets import create_context_by_preset_name as tctx_of
from test_torch_coarsen import port_graph, same, same_graph
from torch_threads import one_torch_thread  # noqa: F401


def _weighted(g):
    """`g` with symmetric edge weights in [1, 9] (odd and even, so that a
    rescaled weight lands on .5 and rounds to even)."""
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    return JaxHostGraph(g.xadj, g.adjncy, None, (lo * 7 + hi * 13) % 9 + 1)


@pytest.fixture(scope="module")
def big():
    """Above the sparsifier's 2^16-edge floor, with the node ids high
    enough that lo * 1_000_003 + hi wraps in int32."""
    g = jfactories.make_rmat(1 << 13, 60_000, seed=2)
    assert g.m > 1 << 16
    return g


@pytest.mark.parametrize("keep", [0.5, 0.4, 0.999, 1.0])
@pytest.mark.parametrize("salt", [7, 0x7FFF51A5])
def test_sparsify_edges_matches_the_jax_package(big, keep, salt):
    jg = jax_upload(_weighted(big))
    tg = port_graph(jg)
    jout = jsparsify.sparsify_edges(jg, jnp.float32(keep), jnp.int32(salt))
    tout = tsparsify.sparsify_edges(tg, keep, salt)
    same_graph(jout, tout)
    dropped = int((tout.dst[: tg.m] == tg.n_pad - 1).sum())
    if keep < 1.0:
        assert 0 < dropped < tg.m
        # kept weights are rescaled by 1 / keep, rounded half to even
        assert (tout.edge_w[: tg.m] != tg.edge_w[: tg.m]).any()
    else:
        assert dropped == 0


def test_sparsification_coarsening_matches_the_jax_package(big):
    jctx, tctx = jctx_of("linear-time-kway"), tctx_of("linear-time-kway")
    assert jctx.coarsening.algorithm == JaxAlgorithm.SPARSIFICATION_CLUSTERING
    assert tctx.coarsening.algorithm == (
        CoarseningAlgorithm.SPARSIFICATION_CLUSTERING)
    tgraph = HostGraph(big.xadj, big.adjncy, big.node_weights,
                       big.edge_weights)
    for ctx, g in ((jctx, big), (tctx, tgraph)):
        ctx.partition.setup(g, k=8, epsilon=0.03)
    jg = jax_upload(big)
    jc = jcoarsener.Coarsener(jctx, jg, big.n)
    tc = tcoarsener.Coarsener(tctx, port_graph(jg), big.n)
    levels = 0
    while tc.current.m > tcoarsener.SPARSIFY_MIN_EDGES:
        went_on = tc.coarsen()
        assert jc.coarsen() == went_on
        if not went_on:
            break
        jl, tl = jc.levels[-1], tc.levels[-1]
        same(jl.coarse.cmap, tl.coarse.cmap)
        same_graph(jl.coarse.graph, tl.coarse.graph)
        levels += 1
    assert levels >= 1


def test_project_down_matches_the_jax_package(big):
    """A partition constant on every cluster projects down to the coarse
    level and back up unchanged."""
    jg = jax_upload(big)
    tg = port_graph(jg)
    labels = np.arange(tg.n_pad, dtype=np.int32)
    labels[: big.n] //= 3
    jcoarse, _, _ = jcon.contract_clustering(jg, jnp.asarray(labels))
    tcoarse, _, _ = tcon.contract_clustering(tg, torch.from_numpy(labels))
    fine = (labels % 5).astype(np.int32)
    jdown = jcoarse.project_down(jnp.asarray(fine))
    tdown = tcoarse.project_down(torch.from_numpy(fine))
    same(jdown, tdown)
    back = tcoarse.project_up(tdown).numpy()
    np.testing.assert_array_equal(back[: big.n], fine[: big.n])
