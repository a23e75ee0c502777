"""Parity of the port's segmented primitives (kaminpar_tpu_torch/ops/segments.py)
with the JAX package's (kaminpar_tpu/ops/segments.py).

Every input is made with numpy from a seed and handed to both packages;
outputs must be equal at zero tolerance (the pipeline is integer).  The
inputs carry ties (narrow value ranges), skewed degrees (R-MAT) and the
padded layout (pad edges at n_pad - 1 with weight 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu.ops import segments as J
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from kaminpar_tpu_torch.ops import segments as T
from torch_threads import one_torch_thread  # noqa: F401

I32 = np.iinfo(np.int32)


def tt(a):
    return torch.from_numpy(np.array(a))


def assert_same(jax_out, torch_out):
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            assert_same(a, b)
        return
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) else (
        np.asarray(torch_out)
    )
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def weighted_rmat(n, m, seed):
    """R-MAT graph with symmetric edge weights in [1, 3] and node weights
    in [1, 4] (weights create ties and uneven cluster sizes)."""
    g = jfactories.make_rmat(n, m, seed=seed)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    lo, hi = np.minimum(src, g.adjncy), np.maximum(src, g.adjncy)
    edge_w = (lo * 7 + hi * 13) % 3 + 1
    node_w = np.random.default_rng(seed).integers(1, 5, g.n)
    return JaxHostGraph(g.xadj, g.adjncy, node_w, edge_w)


def both_graphs(host):
    """The JAX DeviceGraph and the port's, built from the same arrays."""
    jg = jax_upload(host)
    tg = device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device="cpu",
    )
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return both_graphs(weighted_rmat(1 << 9, 4000, seed=5))


SALTS = [0, 1, 12345, -1, -(2**31), 2**31 - 1, 0x2545F491]


@pytest.mark.parametrize("salt", SALTS)
def test_hash_u32_bit_exact(salt):
    rng = np.random.default_rng(1)
    x = rng.integers(I32.min, I32.max, 5000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, I32.min, I32.max]
    assert_same(J.hash_u32(jnp.asarray(x), jnp.int32(salt)),
                T.hash_u32(tt(x), salt))
    assert_same(J.hash_tie16(jnp.asarray(x), jnp.int32(salt)),
                T.hash_tie16(tt(x), salt))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_aggregate_argmax(seed):
    rng = np.random.default_rng(seed)
    m, nseg = 3000, 200
    seg = rng.integers(-1, nseg, m).astype(np.int32)
    key = rng.integers(0, 40, m).astype(np.int32)
    w = rng.integers(0, 4, m).astype(np.int32)
    val = rng.integers(0, 100, m).astype(np.int32)
    assert_same(
        J.sort_by_two_keys(jnp.asarray(seg), jnp.asarray(key),
                           jnp.asarray(val)),
        T.sort_by_two_keys(tt(seg), tt(key), tt(val)),
    )
    jout = J.aggregate_by_key(jnp.asarray(seg), jnp.asarray(key),
                              jnp.asarray(w))
    tout = T.aggregate_by_key(tt(seg), tt(key), tt(w))
    assert_same(jout, tout)
    seg_g, key_g, w_g = (np.asarray(a) for a in jout)
    feasible = rng.random(m) < 0.7
    for feas in (None, feasible):
        assert_same(
            J.argmax_per_segment(
                jnp.asarray(seg_g), jnp.asarray(key_g), jnp.asarray(w_g),
                nseg, jnp.int32(seed * 17 - 3),
                None if feas is None else jnp.asarray(feas),
            ),
            T.argmax_per_segment(
                tt(seg_g), tt(key_g), tt(w_g), nseg, seed * 17 - 3,
                None if feas is None else tt(feas),
            ),
        )
    labels = rng.integers(0, 40, nseg).astype(np.int32)
    assert_same(
        J.connection_to_label(jnp.asarray(seg_g), jnp.asarray(key_g),
                              jnp.asarray(w_g), jnp.asarray(labels), nseg),
        T.connection_to_label(tt(seg_g), tt(key_g), tt(w_g), tt(labels),
                              nseg),
    )


@pytest.mark.parametrize("reach", [False, True])
@pytest.mark.parametrize("float_priority", [False, True])
def test_accept_prefix_by_capacity(reach, float_priority):
    rng = np.random.default_rng(7)
    m, nb = 2000, 30
    target = rng.integers(-1, nb, m).astype(np.int32)
    if float_priority:
        # ties, signed zeros and both signs, as the balancer's keys have
        priority = rng.integers(-5, 5, m).astype(np.float32) / 3
        priority[::97] = -0.0
    else:
        priority = rng.integers(0, 50, m).astype(np.int32)
    weight = rng.integers(1, 6, m).astype(np.int32)
    capacity = rng.integers(0, 120, nb).astype(np.int32)
    assert_same(
        J.accept_prefix_by_capacity(
            jnp.asarray(target), jnp.asarray(priority), jnp.asarray(weight),
            jnp.asarray(capacity), reach=reach,
        ),
        T.accept_prefix_by_capacity(
            tt(target), tt(priority), tt(weight), tt(capacity), reach=reach,
        ),
    )


def test_move_weight_delta_and_compact_unique():
    rng = np.random.default_rng(3)
    n, C = 1000, 64
    labels = rng.integers(0, C, n).astype(np.int32)
    target = rng.integers(-1, C, n).astype(np.int32)
    accept = rng.random(n) < 0.5
    node_w = rng.integers(1, 5, n).astype(np.int32)
    cw = rng.integers(0, 100, C).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (labels, target, accept, node_w)]
    args_t = [tt(a) for a in (labels, target, accept, node_w)]
    assert_same(J.move_weight_delta(*args_j, C),
                T.move_weight_delta(*args_t, C))
    assert_same(J.apply_move_weight_delta(jnp.asarray(cw), *args_j),
                T.apply_move_weight_delta(tt(cw), *args_t))
    sparse = rng.choice(n, 300).astype(np.int32)
    assert_same(J.compact_unique(jnp.asarray(sparse), n),
                T.compact_unique(tt(sparse), n))


@pytest.mark.parametrize("k,with_min", [(3, True), (8, False), (13, True)])
def test_pad_k_bucket(k, with_min):
    mx = np.arange(1, k + 1, dtype=np.int32) * 10
    mn = mx // 2 if with_min else None
    jk, jmx, jmn = J.pad_k_bucket(k, jnp.asarray(mx),
                                  None if mn is None else jnp.asarray(mn))
    tk, tmx, tmn = T.pad_k_bucket(k, tt(mx), None if mn is None else tt(mn))
    assert jk == tk
    assert_same(jmx, tmx)
    if with_min:
        assert_same(jmn, tmn)
    else:
        assert tmn is None


def _neighbor_labels(jg, tg, num_labels, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_labels, tg.n_pad).astype(np.int32)
    nb = labels[np.asarray(jg.dst)]
    return labels, nb


@pytest.mark.parametrize("num_labels", [6, 300])
def test_hash_and_dense_rating_tables(graphs, num_labels):
    jg, tg = graphs
    labels, nb = _neighbor_labels(jg, tg, num_labels, 11)
    salt = 4242
    jtab = J.hashed_rating_table(jg.src, jnp.asarray(nb), jg.edge_w,
                                 jg.n_pad, 16, jnp.int32(salt))
    ttab = T.hashed_rating_table(tg.src, tt(nb), tg.edge_w, tg.n_pad, 16,
                                 salt)
    assert_same(jtab, ttab)
    rng = np.random.default_rng(12)
    cw = rng.integers(0, 30, tg.n_pad).astype(np.int32)
    cap = np.full(tg.n_pad, 25, dtype=np.int32)
    for require_fit in (True, False):
        assert_same(
            J.best_from_rating_table(
                *jtab, jnp.asarray(labels), jnp.asarray(cw), jg.node_w,
                jnp.asarray(cap), jnp.int32(salt ^ 0x51AB),
                require_fit=require_fit,
            ),
            T.best_from_rating_table(
                *ttab, tt(labels), tt(cw), tg.node_w, tt(cap), salt ^ 0x51AB,
                require_fit=require_fit,
            ),
        )
    assert_same(
        J.connection_to_own_label(jg.src, jnp.asarray(nb), jg.edge_w,
                                  jnp.asarray(labels), jg.n_pad),
        T.connection_to_own_label(tg.src, tt(nb), tg.edge_w, tt(labels),
                                  tg.n_pad),
    )


@pytest.mark.parametrize("k", [2, 8, 16])
def test_dense_block_ratings_and_best_from_dense(graphs, k):
    jg, tg = graphs
    rng = np.random.default_rng(k)
    part = rng.integers(0, k, tg.n_pad).astype(np.int32)
    part[-5:] = [-1, k, k + 3, -7, 0]  # out-of-range labels are clipped
    jconn = J.dense_block_ratings(jg.src, jg.dst, jg.edge_w,
                                  jnp.asarray(part), jg.n_pad, k)
    tconn = T.dense_block_ratings(tg.row_ptr[:-1], tg.row_ptr[1:], tg.dst,
                                  tg.edge_w, tt(part), tg.n_pad, k)
    assert_same(jconn, tconn)
    part_c = np.clip(part, 0, k - 1)
    bw = np.bincount(part_c, np.asarray(jg.node_w), k).astype(np.int32)
    cap = (bw + rng.integers(-3, 20, k)).astype(np.int32)
    allowed = rng.random(k) < 0.6
    for kw in ({}, {"require_fit": False}, {"allowed": allowed}):
        jkw = {a: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for a, v in kw.items()}
        tkw = {a: tt(v) if isinstance(v, np.ndarray) else v
               for a, v in kw.items()}
        assert_same(
            J.best_from_dense(jconn, jnp.asarray(part_c), jnp.asarray(bw),
                              jg.node_w, jnp.asarray(cap), jnp.int32(99),
                              **jkw),
            T.best_from_dense(tconn, tt(part_c), tt(bw), tg.node_w, tt(cap),
                              99, **tkw),
        )


@pytest.mark.parametrize("k_best", [1, 3, 6])
def test_rating_top3_by_sort(graphs, k_best):
    jg, tg = graphs
    _, nb = _neighbor_labels(jg, tg, 40, 21)
    assert_same(
        J.rating_top3_by_sort(jg, jnp.asarray(nb), jnp.int32(-77),
                              k_best=k_best),
        T.rating_top3_by_sort(tg, tt(nb), -77, k_best=k_best),
    )


@pytest.mark.parametrize("frac,slots_div", [(0.1, 4), (0.5, 4), (0.9, 2)])
def test_active_rows_and_row_ratings(graphs, frac, slots_div):
    jg, tg = graphs
    rng = np.random.default_rng(int(frac * 100))
    active = rng.random(tg.n_pad) < frac
    num_slots = tg.m_pad // slots_div
    jrows = J.expand_active_rows(jg.row_ptr, jg.degrees, jnp.asarray(active),
                                 num_slots)
    trows = T.expand_active_rows(tg.row_ptr, tg.degrees, tt(active),
                                 num_slots)
    assert_same(jrows, trows)
    owner_c, owner_key, edge_id, valid, start, end = (
        np.asarray(a) for a in jrows
    )
    labels, _ = _neighbor_labels(jg, tg, 30, 5)
    eid = np.clip(edge_id, 0, tg.m_pad - 1)
    nb = np.where(valid, labels[np.asarray(jg.dst)[eid]], -1).astype(np.int32)
    w = np.where(valid, np.asarray(jg.edge_w)[eid], 0).astype(np.int32)
    deg = (end - start).astype(np.int32)
    assert_same(
        J.rating_topk_rows(jnp.asarray(owner_key), jnp.asarray(nb),
                           jnp.asarray(w), jnp.asarray(end),
                           jnp.asarray(deg), jnp.int32(3), 6),
        T.rating_topk_rows(tt(owner_key), tt(nb), tt(w), tt(end), tt(deg),
                           3, 6),
    )
    own = labels[owner_c]
    assert_same(
        J.connection_to_own_rows(jnp.asarray(nb), jnp.asarray(w),
                                 jnp.asarray(own), jnp.asarray(start),
                                 jnp.asarray(end)),
        T.connection_to_own_rows(tt(nb), tt(w), tt(own), tt(start), tt(end)),
    )


@pytest.mark.parametrize("budget_frac", [0.05, 0.3, 2.0])
def test_prune_candidates_to_budget(graphs, budget_frac):
    jg, tg = graphs
    rng = np.random.default_rng(8)
    cand = rng.random(tg.n_pad) < 0.5
    gain = rng.integers(-4, 5, tg.n_pad).astype(np.int32)
    gain[:3] = [I32.min, I32.max, I32.min + 1]
    budget = int(budget_frac * tg.m)
    assert_same(
        J.prune_candidates_to_budget(jnp.asarray(cand), jnp.asarray(gain),
                                     jg.degrees, jnp.int32(-123456789),
                                     budget),
        T.prune_candidates_to_budget(tt(cand), tt(gain), tg.degrees,
                                     -123456789, budget),
    )


@pytest.mark.parametrize("k,gain_scale", [(2, 3), (8, 3), (8, 1 << 12),
                                          (256, 3)])
def test_afterburner_gains(graphs, k, gain_scale):
    """Packed layout (small gains) and exact fallback (gains past the bit
    field, or k too large for packing)."""
    jg, tg = graphs
    rng = np.random.default_rng(k + gain_scale)
    part = rng.integers(0, k, tg.n_pad).astype(np.int32)
    next_part = rng.integers(0, k, tg.n_pad).astype(np.int32)
    gain = rng.integers(-gain_scale, gain_scale + 1, tg.n_pad).astype(
        np.int32
    )
    cand = rng.random(tg.n_pad) < 0.4
    jargs = [jnp.asarray(a) for a in (part, next_part, gain, cand)]
    targs = [tt(a) for a in (part, next_part, gain, cand)]
    assert_same(
        J.packed_afterburner_gain(jg.src, jg.dst, jg.edge_w, jg.row_ptr,
                                  *jargs, k),
        T.packed_afterburner_gain(tg.src, tg.dst, tg.edge_w, tg.row_ptr,
                                  *targs, k),
    )
    active = rng.random(tg.n_pad) < 0.3
    rows = T.expand_active_rows(tg.row_ptr, tg.degrees, tt(active),
                                tg.m_pad // 4)
    owner_c, _, edge_id, valid, start, end = (r.numpy() for r in rows)
    eid = np.clip(edge_id, 0, tg.m_pad - 1)
    dst_b = np.where(valid, np.asarray(jg.dst)[eid], tg.n_pad - 1).astype(
        np.int32
    )
    w_b = np.where(valid, np.asarray(jg.edge_w)[eid], 0).astype(np.int32)
    buf = (owner_c, dst_b, w_b, start, end)
    assert_same(
        J.packed_afterburner_gain_rows(*(jnp.asarray(a) for a in buf),
                                       *jargs, k),
        T.packed_afterburner_gain_rows(*(tt(a) for a in buf), *targs, k),
    )
    gain_by_node = np.where(cand, gain, I32.min).astype(np.int32)
    src = np.asarray(jg.src)
    dst = np.asarray(jg.dst)
    fargs = (src, dst, np.asarray(jg.edge_w), part[src], part[dst],
             gain_by_node, next_part, src)
    assert_same(
        J.afterburner_filter(*(jnp.asarray(a) for a in fargs), tg.n_pad),
        T.afterburner_filter(*(tt(a) for a in fargs), tg.n_pad),
    )


def test_neighbor_any_true(graphs):
    jg, tg = graphs
    flag = np.random.default_rng(2).random(tg.n_pad) < 0.05
    assert_same(J.neighbor_any_true(jnp.asarray(flag), jg.dst, jg.row_ptr),
                T.neighbor_any_true(tt(flag), tg.dst, tg.row_ptr))
