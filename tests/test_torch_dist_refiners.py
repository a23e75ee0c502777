"""The dist refiners and clusterers beyond the default pipeline, port
against JAX package on the 8-device CPU mesh, bitwise: Jet
(parallel/dist_jet.py), the greedy coloring and colored LP
(dist_coloring.py, dist_clp.py), the cluster balancer
(dist_cluster_balancer.py), heavy-edge matching and HEM+LP
(dist_hem.py), on one shard layout handed to both packages; the presets
and clusterers that run them through dKaMinPar; and the BFS region
extractor (graphs/bfs_extractor.py).
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.graphs import bfs_extractor as jbfs
from kaminpar_tpu.graphs import factories as jf
from kaminpar_tpu.parallel.dist_context import (
    DistClusteringAlgorithm as JClu,
)
import kaminpar_tpu_torch.parallel as tp
from kaminpar_tpu_torch import convert
from kaminpar_tpu_torch.graphs import bfs_extractor as tbfs
from kaminpar_tpu_torch.parallel.dist_context import (
    DistClusteringAlgorithm as TClu,
)
from torch_dist_pairs import as_port, quiet, run_pair  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("quiet")

FIELDS = ("src", "dst", "edge_w", "node_w", "n", "m", "dst_local",
          "ghost_gid", "send_idx", "recv_map")
K = 8


@pytest.fixture(scope="module")
def rmat():
    return jf.make_rmat(1 << 11, 16_000, seed=3)


@pytest.fixture(scope="module", params=[4, (2, 4)], ids=["D4", "D2x4"])
def pair(rmat, request):
    a = jp.dist_graph_from_host(rmat, jp.make_mesh(request.param))
    b = convert.dist_graph_from_arrays(
        {f: np.asarray(getattr(a, f)) for f in FIELDS},
        tp.make_mesh(request.param, device="cpu"))
    return rmat, a, b


@pytest.fixture(scope="module")
def grid4():
    """A 64x64 grid on 4 shards: few colors, so colored LP stays short."""
    g = jf.make_grid_graph(64, 64)
    a = jp.dist_graph_from_host(g, jp.make_mesh(4))
    b = convert.dist_graph_from_arrays(
        {f: np.asarray(getattr(a, f)) for f in FIELDS},
        tp.make_mesh(4, device="cpu"))
    return g, a, b


def caps_for(g):
    return np.full(K, int(g.n * 1.03 / K) + 1, np.int32)


def test_jet_refine_bitwise(grid4):
    g, a, b = grid4
    part = (np.arange(a.n_pad) * 7 % K).astype(np.int32)
    caps = caps_for(g)
    want = np.asarray(jp.dist_jet_refine(a, part, K, caps, 5))
    got = tp.dist_jet_refine(b, torch.from_numpy(part), K,
                             torch.from_numpy(caps), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_coloring_and_colored_lp_bitwise(grid4):
    g, a, b = grid4
    jc, jn = jp.dist_greedy_coloring(a, 7)
    tc, tn = tp.dist_greedy_coloring(b, 7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tn == int(jn)
    # every color class is an independent set
    col = tc.numpy()[: g.n]
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    assert not (col[src] == col[g.adjncy]).any()
    part = (np.arange(a.n_pad) * 7 % K).astype(np.int32)
    caps = caps_for(g)
    want = np.asarray(jp.dist_colored_lp_refine(a, part, K, caps, 5))
    got = tp.dist_colored_lp_refine(b, torch.from_numpy(part), K,
                                    torch.from_numpy(caps), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cluster_balance_bitwise(pair):
    g, a, b = pair
    bad = np.where(np.arange(a.n_pad) < g.n * 3 // 4,
                   np.arange(a.n_pad) % 4, K - 1).astype(np.int32)
    caps = caps_for(g)
    want = np.asarray(jp.dist_cluster_balance(a, bad, K, caps, 3))
    got = tp.dist_cluster_balance(b, torch.from_numpy(bad), K,
                                  torch.from_numpy(caps), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bad).sum() > 0


def test_hem_and_hem_lp_bitwise(pair):
    g, a, b = pair
    want = np.asarray(jp.dist_hem_cluster(a, 30, 5))
    got = tp.dist_hem_cluster(b, 30, 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != np.arange(a.n_pad)).sum() > 0
    want = np.asarray(jp.dist_hem_lp_cluster(a, 30, 5))
    np.testing.assert_array_equal(tp.dist_hem_lp_cluster(b, 30, 5).numpy(),
                                  want)


@pytest.mark.parametrize("preset", ["colored-lp", "cluster-balancer"])
def test_refiner_presets_bitwise(rmat, preset):
    run_pair(jf.make_grid_graph(40, 40) if preset == "colored-lp" else rmat,
             2, preset)


@pytest.mark.parametrize("algo", ["global-hem", "global-hem-lp"])
def test_hem_clusterers_bitwise(rmat, algo):
    def configure(ctx, which):
        ctx.clustering = (JClu if which == "jax" else TClu)(algo)
    run_pair(rmat, 4, configure=configure)


def test_bfs_extractor_bitwise():
    g = jf.make_grid_graph(20, 30)
    part = (np.arange(g.n) * 5 % 4).astype(np.int32)
    seeds = np.array([0, 77, 410])
    for hops in (1, 3):
        want = jbfs.extract_bfs_subgraph(g, part, seeds, hops, 4)
        got = tbfs.extract_bfs_subgraph(as_port(g), part, seeds, hops, 4)
        for f in ("xadj", "adjncy"):
            np.testing.assert_array_equal(getattr(got.graph, f),
                                          getattr(want.graph, f))
        np.testing.assert_array_equal(got.graph.edge_weight_array(),
                                      want.graph.edge_weight_array())
        np.testing.assert_array_equal(got.graph.node_weight_array(),
                                      want.graph.node_weight_array())
        np.testing.assert_array_equal(got.node_mapping, want.node_mapping)
        np.testing.assert_array_equal(got.partition, want.partition)
        assert got.num_region == want.num_region
        moved = got.partition.copy()
        moved[: got.num_region] = 0
        np.testing.assert_array_equal(got.project_back(moved, part),
                                      want.project_back(moved, part))
    np.testing.assert_array_equal(
        tbfs._host_bfs(as_port(g), seeds, 4), jbfs._host_bfs(g, seeds, 4))
