"""The port's shard mesh (kaminpar_tpu_torch/parallel/mesh.py) and sharded
graph (parallel/dist_graph.py) against the JAX package's on the 8-device
CPU mesh: every DistGraph field bitwise at D in {2, 8} and on a (2, 4)
grid, from plain and compressed inputs, the halo exchange against the
JAX shard_map'd exchange, the dist edge cut, the collectives' semantics,
the sizing and fingerprints, and the replication helpers.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.graphs import factories as jf
from kaminpar_tpu.graphs.compressed import compress_host_graph as jcompress
from kaminpar_tpu.parallel import dist_graph as jdg_mod
from kaminpar_tpu.parallel import mesh as jmesh
from kaminpar_tpu.parallel import replication as jrep
from kaminpar_tpu_torch import convert
from kaminpar_tpu_torch.graphs.compressed import compress_host_graph
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.parallel import dist_graph as tdg_mod
from kaminpar_tpu_torch.parallel import mesh as tmesh
from kaminpar_tpu_torch.parallel import replication as trep
from kaminpar_tpu_torch.parallel.dist_metrics import dist_edge_cut
from torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("src", "dst", "edge_w", "node_w", "dst_local", "ghost_gid",
          "send_idx", "recv_map")
MESHES = [2, 8, (2, 4)]


def as_port(g) -> HostGraph:
    return HostGraph(xadj=g.xadj, adjncy=g.adjncy,
                     node_weights=g.node_weights,
                     edge_weights=g.edge_weights)


@pytest.fixture(scope="module")
def rmat():
    return jf.make_rmat(1 << 11, 16_000, seed=3)


def pair(g, D):
    a = jp.dist_graph_from_host(g, jp.make_mesh(D))
    b = tdg_mod.dist_graph_from_host(as_port(g), tmesh.make_mesh(D,
                                                                 device="cpu"))
    return a, b


def assert_fields(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
    assert (int(a.n), int(a.m)) == (b.n, b.m)
    assert (a.n_pad, a.g_loc, a.s_max) == (b.n_pad, b.g_loc, b.s_max)


@pytest.mark.parametrize("D", MESHES)
def test_dist_graph_from_host_every_field(rmat, D):
    a, b = pair(rmat, D)
    assert_fields(a, b)
    # the port's own field: each shard's CSR rows over its real edges
    n_loc = b.n_loc
    for sh in b.shards():
        v0 = min(sh.offset, rmat.n)
        v1 = min(sh.offset + n_loc, rmat.n)
        rp = np.asarray(rmat.xadj[v0: v1 + 1]) - rmat.xadj[v0]
        np.testing.assert_array_equal(sh.row_end.numpy()[: v1 - v0], rp[1:])


@pytest.mark.parametrize("D", MESHES)
def test_dist_graph_from_compressed_every_field(rmat, D):
    a = jp.dist_graph_from_compressed(jcompress(rmat), jp.make_mesh(D))
    b = tdg_mod.dist_graph_from_compressed(
        compress_host_graph(as_port(rmat)), tmesh.make_mesh(D, device="cpu"))
    assert_fields(a, b)


@pytest.mark.parametrize("D", [2, 8])
def test_dist_graph_weighted_grid_and_isolated(D):
    g = jf.make_grid_graph(20, 24)
    a, b = pair(g, D)
    assert_fields(a, b)
    g = jf.make_isolated_graph(300)
    a, b = pair(g, D)
    assert_fields(a, b)


@pytest.mark.parametrize("D", MESHES)
def test_dist_graph_from_arrays_round_trip(rmat, D):
    a, b = pair(rmat, D)
    c = convert.dist_graph_from_arrays(
        {f: np.asarray(getattr(a, f)) for f in FIELDS + ("n", "m")},
        tmesh.make_mesh(D, device="cpu"))
    assert_fields(a, c)
    np.testing.assert_array_equal(c.row_ptr.numpy(), b.row_ptr.numpy())


def _jax_halo(a, vals):
    g_loc = a.g_loc

    def per_device(vals_l, send_idx_l, recv_map_l):
        return jmesh.halo_exchange(vals_l, send_idx_l, recv_map_l, g_loc)

    out = jmesh.shard_map_compat(
        per_device, mesh=a.src.sharding.mesh,
        in_specs=(P(jmesh.NODE_AXIS),) * 3, out_specs=P(jmesh.NODE_AXIS),
    )(vals, a.send_idx, a.recv_map)
    return np.asarray(out)


@pytest.mark.parametrize("D", [2, 8])
def test_halo_exchange_matches_jax(rmat, D):
    a, b = pair(rmat, D)
    vals = (np.arange(a.n_pad, dtype=np.int32) * 7 + 3)
    want = _jax_halo(a, vals).reshape(D, a.g_loc)
    n_loc = b.n_loc
    shards = b.shards()
    got = tmesh.halo_exchange(
        [torch.from_numpy(vals[d * n_loc:(d + 1) * n_loc]) for d in range(D)],
        [sh.send_idx for sh in shards], [sh.recv_map for sh in shards],
        b.g_loc)
    gid = b.ghost_gid.numpy().reshape(D, b.g_loc)
    for d in range(D):
        real = gid[d] != a.n_pad - 1
        np.testing.assert_array_equal(got[d].numpy()[real], want[d][real])
        np.testing.assert_array_equal(got[d].numpy()[real], vals[gid[d][real]])
    # stacked values share one exchange
    two = tmesh.halo_exchange(
        [torch.stack([torch.from_numpy(vals[d * n_loc:(d + 1) * n_loc])] * 2)
         for d in range(D)],
        [sh.send_idx for sh in shards], [sh.recv_map for sh in shards],
        b.g_loc)
    for d in range(D):
        np.testing.assert_array_equal(two[d][1].numpy(), got[d].numpy())


@pytest.mark.parametrize("D", MESHES)
def test_dist_edge_cut_matches_jax(rmat, D):
    a, b = pair(rmat, D)
    labels = (np.arange(a.n_pad) * 2654435761 % 5).astype(np.int32)
    want = int(jp.dist_edge_cut(a, labels))
    assert dist_edge_cut(b, torch.from_numpy(labels)) == want
    src = np.repeat(np.arange(rmat.n), np.diff(rmat.xadj))
    host = int(rmat.edge_weight_array()[
        labels[src] != labels[rmat.adjncy]].sum() // 2)
    assert want == host


def test_collectives_semantics():
    xs = [torch.arange(4, dtype=torch.int32).view(2, 2) + 10 * d
          for d in range(2)]
    out = tmesh.all_to_all(xs)
    # shard d's block p lands in shard p's block d
    for p in range(2):
        for d in range(2):
            assert torch.equal(out[p][d], xs[d][p])
    assert torch.equal(tmesh.all_gather([torch.tensor([1]),
                                         torch.tensor([2, 3])]),
                       torch.tensor([1, 2, 3]))
    assert torch.equal(tmesh.psum([torch.tensor([1, 2]),
                                   torch.tensor([3, 4])]),
                       torch.tensor([4, 6]))


def test_mesh_shapes_and_devices():
    m = tmesh.make_mesh(8, device="cpu")
    assert m.shape == (1, 8) and m.size == 8
    t = tmesh.make_torus_mesh(2, 4, device="cpu")
    assert t.shape == (2, 4) and t.size == 8
    e = tmesh.make_mesh((2, 2), devices=["cpu", "cpu"])
    assert e.devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        tmesh.Mesh([torch.device("cpu")] * 3, (2, 2))
    with pytest.raises(RuntimeError):
        if not torch.cuda.is_available():
            tmesh.make_mesh(2)  # the card is the default


def test_comm_accounting_counts_calls():
    tmesh.reset_comm_log()
    with tmesh.comm_phase("p"):
        tmesh.account_collective("psum(x)", 16, shape=(4,))
        tmesh.account_collective("psum(x)", 16, shape=(4,))
        tmesh.account_collective("psum(y)", 4, shape=())
    tmesh.account_collective("outside", 4)
    recs = tmesh.comm_records()
    assert [(r["phase"], r["op"], r["shape"], r["calls"],
             r["payload_bytes_per_device"]) for r in recs] == [
        ("p", "psum(x)", [4], 2, 16), ("p", "psum(y)", [], 1, 4)]
    assert tmesh.comm_phase_totals() == {"p": {"bytes_total": 36,
                                               "calls": 3}}
    assert "per CALL" in tmesh.comm_table()
    tmesh.reset_comm_log()


@pytest.mark.parametrize("D", [1, 2, 8])
def test_shard_sizes_and_fingerprints_match_jax(rmat, D):
    assert tdg_mod.shard_sizes(rmat.xadj, D) == jdg_mod.shard_sizes(
        rmat.xadj, D)
    assert tdg_mod.shard_fingerprints(rmat, D) == (
        jdg_mod.shard_fingerprints(rmat, D))


def test_dist_graph_bytes_match_jax(rmat):
    a, b = pair(rmat, 8)
    assert tdg_mod.dist_graph_bytes(b) == jdg_mod.dist_graph_bytes(a)


def test_replication_helpers_match_jax(rmat):
    for n, D, thr in ((100, 8, 2048), (40_000, 8, 2048), (3000, 4, 1000),
                      (10, 1, 5)):
        assert trep.choose_replication_factor(n, D, thr) == (
            jrep.choose_replication_factor(n, D, thr))
    u_j, u_t = jrep.union_graph(rmat, 4), trep.union_graph(as_port(rmat), 4)
    np.testing.assert_array_equal(u_j.xadj, u_t.xadj)
    np.testing.assert_array_equal(u_j.adjncy, u_t.adjncy)
    s_j = jrep.slice_replica(u_j, rmat.n, 2 * rmat.n)
    s_t = trep.slice_replica(u_t, rmat.n, 2 * rmat.n)
    np.testing.assert_array_equal(s_j.adjncy, s_t.adjncy)
    part = (np.arange(4 * rmat.n) % 8 + np.repeat(np.arange(4), rmat.n) * 8
            ).astype(np.int32)
    jb, tb = (jrep.best_replica_partition(rmat, part, 4, 8),
              trep.best_replica_partition(as_port(rmat), part, 4, 8))
    np.testing.assert_array_equal(jb[0], tb[0])
    assert jb[1:] == tb[1:]
    cmap = np.arange(4 * rmat.n) // 3
    assert trep.replica_bounds_after_contraction(cmap, [0, 5, 9]) == (
        jrep.replica_bounds_after_contraction(cmap, [0, 5, 9]))
