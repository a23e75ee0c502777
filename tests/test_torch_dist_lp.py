"""The port's dist kernels' modules against the JAX package's on the
8-device CPU mesh, bitwise: LP clustering with every engine (auto, the
scatter engine, local-lp, hash, sort), clustering from a given labeling
with frozen nodes, LP refinement (the dense engine), the node balancer,
the singleton post-passes and the sharded contraction under star and
power-law skew.  Both packages get one shard layout: the port's graph is
built from the JAX DistGraph's fields (convert.dist_graph_from_arrays).

The kernels on this path take their plain twins here: K2 with a
ghost-extended label table and the standalone K3 with `label_range` and
`communities` are held against the JAX package's functions at dist
shard shapes; the `cuda`-marked test holds the CUDA kernels against
their twins with the same masks on a card.
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.graphs import factories as jf
from kaminpar_tpu.ops import rating as jrating
from kaminpar_tpu.ops import segments as jseg
from kaminpar_tpu.ops.lp import LPConfig as JCfg
from kaminpar_tpu.parallel import dist_contraction as jdc
from kaminpar_tpu.parallel.dist_lp import (
    dist_singleton_postpasses as j_postpasses,
)
from kaminpar_tpu_torch import convert
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.ops import gather, rating
from kaminpar_tpu_torch.ops.lp import LPConfig as TCfg
from kaminpar_tpu_torch.parallel import dist_balancer as tbal
from kaminpar_tpu_torch.parallel import dist_contraction as tdc
from kaminpar_tpu_torch.parallel import dist_lp as tlp
from kaminpar_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("src", "dst", "edge_w", "node_w", "n", "m", "dst_local",
          "ghost_gid", "send_idx", "recv_map")


def as_port(g) -> HostGraph:
    return HostGraph(xadj=g.xadj, adjncy=g.adjncy,
                     node_weights=g.node_weights,
                     edge_weights=g.edge_weights)


def port_of(a, D):
    return convert.dist_graph_from_arrays(
        {f: np.asarray(getattr(a, f)) for f in FIELDS},
        tmesh.make_mesh(D, device="cpu"))


@pytest.fixture(scope="module")
def graphs():
    g = jf.make_rmat(1 << 11, 16_000, seed=3)
    out = {}
    for D in (8, (2, 4)):
        a = jp.dist_graph_from_host(g, jp.make_mesh(D))
        out[D] = (a, port_of(a, D))
    return g, out


CLUSTER_CASES = [
    ("auto", False), ("scatter", False), ("scatter", True), ("hash", False),
    ("sort", True),
]


@pytest.mark.parametrize("rating_engine,local", CLUSTER_CASES)
@pytest.mark.parametrize("D", [8, (2, 4)])
def test_dist_lp_cluster_bitwise(graphs, rating_engine, local, D):
    _, by_d = graphs
    a, b = by_d[D]
    want = np.asarray(jp.dist_lp_cluster(
        a, 60, 5, cfg=JCfg(rating=rating_engine, dist_local_only=local)))
    got = tlp.dist_lp_cluster(
        b, 60, 5, cfg=TCfg(rating=rating_engine, dist_local_only=local))
    np.testing.assert_array_equal(got.numpy(), want)
    if local:  # local-lp: no cluster spans two shards
        n_loc = b.n_loc
        assert (got.numpy() // n_loc == np.arange(b.n_pad) // n_loc).all()


def test_dist_lp_cluster_sort2_is_refused(graphs):
    _, by_d = graphs
    with pytest.raises(ValueError, match="sort2"):
        tlp.dist_lp_cluster(by_d[8][1], 60, 5, cfg=TCfg(rating="sort2"))


def test_dist_lp_cluster_from_with_frozen_nodes(graphs):
    g, by_d = graphs
    a, b = by_d[8]
    rng = np.random.default_rng(4)
    labels0 = np.arange(a.n_pad, dtype=np.int32)
    labels0[: g.n] = (np.arange(g.n) // 2) * 2  # pairs
    movable = rng.random(a.n_pad) < 0.7
    want = np.asarray(jp.dist_lp_cluster_from(a, labels0, movable, 40, 9))
    got = tlp.dist_lp_cluster_from(b, torch.from_numpy(labels0),
                                   torch.from_numpy(movable), 40, 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("D", [8, (2, 4)])
def test_dist_lp_refine_bitwise(graphs, k, D):
    g, by_d = graphs
    a, b = by_d[D]
    part = (np.arange(a.n_pad) * 7 % k).astype(np.int32)
    caps = np.full(k, int(g.n * 1.03 / k) + 1, np.int32)
    want = np.asarray(jp.dist_lp_refine(a, part, k, caps, 7))
    got = tlp.dist_lp_refine(b, torch.from_numpy(part), k,
                             torch.from_numpy(caps), 7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert jp.dist_edge_cut(a, want) < jp.dist_edge_cut(a, part)


@pytest.mark.parametrize("k", [2, 8])
def test_dist_node_balance_bitwise(graphs, k):
    g, by_d = graphs
    a, b = by_d[8]
    part = np.where(np.arange(a.n_pad) < g.n * 3 // 4,
                    np.arange(a.n_pad) % max(k // 2, 1),
                    k - 1).astype(np.int32)
    caps = np.full(k, int(g.n * 1.03 / k) + 1, np.int32)
    want = np.asarray(jp.dist_node_balance(a, part, k, caps, 3))
    got = tbal.dist_node_balance(b, torch.from_numpy(part), k,
                                 torch.from_numpy(caps), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != part).sum() > 0
    bw = np.bincount(want[: g.n], minlength=k)
    assert (bw <= caps).all()


def test_singleton_postpasses_bitwise():
    for g in (jf.make_star(500), jf.make_isolated_graph(700),
              jf.make_grid_graph(12, 40)):
        labels = np.arange(g.n + 64, dtype=np.int32)
        for cap in (3, 40):
            want = j_postpasses(g, labels, cap)
            got = tlp.dist_singleton_postpasses(as_port(g), labels, cap)
            np.testing.assert_array_equal(got, want)
            got_t = tlp.dist_singleton_postpasses(
                as_port(g), torch.from_numpy(labels), cap)
            np.testing.assert_array_equal(got_t, want)


def _contract_pair(g, labels, monkeypatch):
    mesh_j = jp.make_mesh(8)
    a = jp.dist_graph_from_host(g, mesh_j)
    b = port_of(a, 8)
    monkeypatch.setattr(jdc, "BUCKET_MIN", 1 << 10)
    monkeypatch.setattr(tdc, "BUCKET_MIN", 1 << 10)
    jdc._dist_contract_edges_impl.clear_cache()
    try:
        cj, mj = jdc.dist_contract_clustering(a, g.n, g.node_weight_array(),
                                              labels)
    finally:
        jdc._dist_contract_edges_impl.clear_cache()
    ct, mt = tdc.dist_contract_clustering(b, g.n, g.node_weight_array(),
                                          labels)
    np.testing.assert_array_equal(mt, mj)
    for f in ("xadj", "adjncy"):
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    np.testing.assert_array_equal(ct.edge_weight_array(),
                                  cj.edge_weight_array())
    np.testing.assert_array_equal(ct.node_weight_array(),
                                  cj.node_weight_array())


def test_sharded_contraction_star_skew(monkeypatch):
    g = jf.make_star((1 << 12) - 1)
    n_pad = jp.dist_graph_from_host(g, jp.make_mesh(8)).n_pad
    _contract_pair(g, np.arange(n_pad, dtype=np.int64), monkeypatch)


def test_sharded_contraction_powerlaw_skew(monkeypatch):
    g = jf.make_rmat(1 << 11, 30_000, seed=5)
    n_pad = jp.dist_graph_from_host(g, jp.make_mesh(8)).n_pad
    rng = np.random.default_rng(11)
    ncl = 64
    p = 1.0 / np.arange(1, ncl + 1) ** 1.2
    cl = rng.choice(ncl, size=g.n, p=p / p.sum())
    leaders = np.array([np.flatnonzero(cl == c)[0] if (cl == c).any()
                        else -1 for c in range(ncl)])
    labels = np.arange(n_pad, dtype=np.int64)
    labels[: g.n] = leaders[cl]
    _contract_pair(g, labels, monkeypatch)


# ------------------------------------------------------- the path's kernels


def _shard_tables(graphs, d=0):
    """Shard d's first-round scatter tables and ghost label table (the
    JAX engine's inputs), at the dist shapes: rows n_loc, labels global."""
    _, by_d = graphs
    a, b = by_d[8]
    sh = b.shard(d)
    n_loc, g_loc = b.n_loc, b.g_loc
    C = b.n_pad
    labels = np.arange(C, dtype=np.int32)
    lab_tab = np.concatenate([labels[sh.offset: sh.offset + n_loc],
                              labels[sh.ghost_gid.numpy()]])
    dstloc = sh.dst_local.clamp(0, n_loc + g_loc - 1).numpy()
    seg = (sh.src - sh.offset).numpy()
    nb = lab_tab[dstloc]
    return a, b, sh, lab_tab, dstloc, seg, nb, C


def test_k3_label_range_and_communities_at_shard_shapes(graphs):
    import jax.numpy as jnp

    a, b, sh, lab_tab, dstloc, seg, nb, C = _shard_tables(graphs, d=1)
    n_loc = b.n_loc
    ew = sh.edge_w.numpy()
    sl, sw, _ = jrating.scatter_slot_ratings(
        jnp.asarray(np.clip(seg, 0, n_loc - 1)), jnp.asarray(nb),
        jnp.asarray(ew), n_loc, 8, 17, label_space=C)
    tsl, tsw, _ = rating.scatter_slot_ratings(
        torch.from_numpy(np.clip(seg, 0, n_loc - 1)), torch.from_numpy(nb),
        torch.from_numpy(ew), n_loc, 8, 17, label_space=C)
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(sl))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))
    own = lab_tab[:n_loc]
    weights = np.array(a.node_w)
    cap = np.full(C, 40, np.int32)
    nw = sh.node_w.numpy()
    comm = (np.arange(n_loc) % 3).astype(np.int32)
    lo, hi = sh.offset, sh.offset + n_loc
    for kw_j, kw_t in (
        ({}, {}),
        ({"label_range": (jnp.int32(lo), jnp.int32(hi))},
         {"label_range": (lo, hi)}),
        ({"communities": jnp.asarray(comm)},
         {"communities": torch.from_numpy(comm)}),
    ):
        want = jrating.best_from_slots(sl, sw, jnp.asarray(own),
                                       jnp.asarray(weights), jnp.asarray(nw),
                                       jnp.asarray(cap), 5, **kw_j)
        got = rating.best_from_slots(tsl, tsw, torch.from_numpy(own),
                                     torch.from_numpy(weights.copy()),
                                     torch.from_numpy(nw),
                                     torch.from_numpy(cap), 5, **kw_t)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the range mask changes winners on this shard
    plain = rating.best_from_slots(tsl, tsw, torch.from_numpy(own),
                                   torch.from_numpy(weights.copy()),
                                   torch.from_numpy(nw),
                                   torch.from_numpy(cap), 5)[0]
    ranged = rating.best_from_slots(tsl, tsw, torch.from_numpy(own),
                                    torch.from_numpy(weights.copy()),
                                    torch.from_numpy(nw),
                                    torch.from_numpy(cap), 5,
                                    label_range=(lo, hi))[0]
    assert (plain != ranged).any()


def test_k2_ghost_extended_label_table(graphs):
    import jax.numpy as jnp

    a, b, sh, lab_tab, dstloc, seg, nb, C = _shard_tables(graphs, d=0)
    n_loc = b.n_loc
    k = 8
    part_tab = (lab_tab * 5 % k).astype(np.int32)
    want = jseg.dense_block_ratings(
        jnp.asarray(seg), jnp.asarray(dstloc), jnp.asarray(sh.edge_w.numpy()),
        jnp.asarray(part_tab), n_loc, k)
    got = gather.dense_block_ratings(
        sh.row_start, sh.row_end, torch.from_numpy(dstloc), sh.edge_w,
        torch.from_numpy(part_tab), n_loc, k)
    assert part_tab.shape[0] > n_loc
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.cuda
def test_dist_kernels_with_masks_match_twins_on_card(graphs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and run the "
                    "CUDA kernels")
    dev = torch.device("cuda")
    a, b, sh, lab_tab, dstloc, seg, nb, C = _shard_tables(graphs, d=1)
    n_loc = b.n_loc
    tsl, tsw, _ = rating.scatter_slot_ratings(
        torch.from_numpy(np.clip(seg, 0, n_loc - 1)).to(dev),
        torch.from_numpy(nb).to(dev), sh.edge_w.to(dev), n_loc, 8, 17,
        label_space=C)
    args = (tsl, tsw, torch.from_numpy(lab_tab[:n_loc]).to(dev),
            b.node_w.to(dev), sh.node_w.to(dev),
            torch.full((C,), 40, dtype=torch.int32, device=dev), 5)
    comm = torch.arange(n_loc, dtype=torch.int32, device=dev) % 3
    for kw in ({"label_range": (sh.offset, sh.offset + n_loc)},
               {"communities": comm}):
        got = rating.best_from_slots(*args, **kw)
        want = rating.best_from_slots_twin(*args, **kw)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    part_tab = torch.from_numpy((lab_tab * 5 % 8).astype(np.int32)).to(dev)
    k2 = (sh.row_start.to(dev), sh.row_end.to(dev),
          torch.from_numpy(dstloc).to(dev), sh.edge_w.to(dev), part_tab,
          n_loc, 8)
    assert torch.equal(gather.dense_block_ratings(*k2),
                       gather.dense_block_ratings_twin(*k2))
