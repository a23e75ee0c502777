"""The port's three kernels (K1 gather_i32, K2 dense_block_ratings, K3
best_from_slots) against the JAX package's TPU kernels and lax paths.

On the CPU each wrapper runs its plain torch twin, so these tests hold
the twins' arithmetic against the Pallas kernels (run in interpret mode,
as the JAX package's own tests do) at zero tolerance.  The CUDA kernels
themselves are compared with their twins by the `cuda`-marked test at
the end, which needs an NVIDIA card and skips elsewhere, and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu.ops.lane_gather as lg
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.ops import rating as jrating
from kaminpar_tpu.ops import segments as jseg
from kaminpar_tpu_torch import _native
from kaminpar_tpu_torch.convert import (
    device_graph_from_arrays,
    labels_from_numpy,
)
from kaminpar_tpu_torch.ops import gather, rating
from kaminpar_tpu_torch.ops import segments as T
from torch_threads import one_torch_thread  # noqa: F401

I32_MIN = np.iinfo(np.int32).min


def tt(a):
    return torch.from_numpy(np.array(a))


def port_graph(jg):
    return device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device="cpu",
    )


@pytest.fixture(scope="module")
def graphs():
    jg = jax_upload(jfactories.make_rmat(1 << 10, 8000, seed=5))
    return jg, port_graph(jg)


@pytest.fixture
def routed(monkeypatch):
    """The JAX lane-routed path in interpret mode at any size."""
    monkeypatch.setattr(lg, "INTERPRET", True)
    monkeypatch.setattr(lg, "MIN_EDGE_SLOTS", 0)
    monkeypatch.setattr(lg, "PLAN_MAX_SLOT_RATIO", float("inf"))
    lg.clear_plan_cache()
    yield
    lg.clear_plan_cache()


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize(
    "table_len,m,chunk_rows,skewed",
    [(1024, 300, None, False), (64 * lg.L, 1000, 16, False),
     (8 * lg.L, 200, None, True)],
)
def test_k1_matches_lane_gather_through_inv(table_len, m, chunk_rows,
                                            skewed):
    """K1 works in edge order; the TPU kernel in routed slot order.  Held
    together through plan.inv (slot -> edge, -1 = pad)."""
    rng = np.random.default_rng(table_len + m)
    if skewed:  # every index in one lane: worst-case routing
        idx = ((np.arange(m) % 5) * lg.L + 3).astype(np.int32)
    else:
        idx = rng.integers(0, table_len, m).astype(np.int32)
    idx[:2] = [0, table_len - 1]
    table = rng.integers(-(1 << 30), 1 << 30, table_len).astype(np.int32)
    kw = {} if chunk_rows is None else {"chunk_rows": chunk_rows}
    plan = lg.build_gather_plan(jnp.asarray(idx), table_len, **kw)
    routed_out = np.asarray(
        lg.lane_gather(jnp.asarray(table), plan, interpret=True)
    )
    inv = np.asarray(plan.inv)
    ok = inv >= 0
    before = gather.gather_i32.launches
    out = gather.gather_i32(tt(table), tt(idx)).numpy()
    assert gather.gather_i32.launches == before  # CPU: the twin, no launch
    np.testing.assert_array_equal(routed_out[ok], out[inv[ok]])
    np.testing.assert_array_equal(out, table[idx])


def test_k1_on_level_dst(graphs):
    """The path's use: labels[dst] over a padded level (pad edges read the
    pad node n_pad - 1)."""
    jg, tg = graphs
    labels = np.random.default_rng(3).integers(0, 50, tg.n_pad).astype(
        np.int32
    )
    plan = lg.build_gather_plan(jg.dst, tg.n_pad)
    routed_out = np.asarray(
        lg.lane_gather(jnp.asarray(labels), plan, interpret=True)
    )
    inv = np.asarray(plan.inv)
    ok = inv >= 0
    out = gather.gather_i32(tt(labels), tg.dst).numpy()
    np.testing.assert_array_equal(routed_out[ok], out[inv[ok]])


# ---------------------------------------------------------------- K2


def _spans(tg):
    return tg.row_ptr[:-1], tg.row_ptr[1:]


@pytest.mark.parametrize("k", [2, 16, 256])
def test_k2_matches_routed_and_segment_ratings(graphs, routed, k):
    jg, tg = graphs
    rng = np.random.default_rng(k)
    labels = rng.integers(-2, k + 2, tg.n_pad).astype(np.int32)
    plans = lg.edge_plans(jg)
    assert plans is not None
    jr = np.asarray(lg.routed_block_ratings(plans, jnp.asarray(labels), k,
                                            tg.n_pad))
    js = np.asarray(jseg.dense_block_ratings(jg.src, jg.dst, jg.edge_w,
                                             jnp.asarray(labels), tg.n_pad,
                                             k))
    before = gather.dense_block_ratings.launches
    out = gather.dense_block_ratings(
        *_spans(tg), tg.dst, tg.edge_w, labels_from_numpy(labels, "cpu"),
        tg.n_pad, k,
    ).numpy()
    assert gather.dense_block_ratings.launches == before
    assert out.shape == (tg.n_pad, k)
    np.testing.assert_array_equal(jr, out)
    np.testing.assert_array_equal(js, out)


@pytest.mark.parametrize("k", [4, 64])
@pytest.mark.parametrize("slot_share", [0.3, 1.5])
def test_k2_delta_round_spans_cut_at_the_buffer(graphs, k, slot_share):
    """A delta round's compacted rows: the spans of expand_active_rows run
    past the buffer when the active rows hold more slots than it has, and
    the twin, reading only the clipped spans, still gives the JAX table
    built from the slots' owners."""
    jg, tg = graphs
    rng = np.random.default_rng(int(slot_share * 10) + k)
    active = rng.random(tg.n_pad) < 0.4
    degrees = np.diff(np.asarray(jg.row_ptr))
    num_slots = max(1, int(slot_share * degrees[active].sum()))
    rows = jseg.expand_active_rows(jg.row_ptr, jnp.asarray(degrees),
                                   jnp.asarray(active), num_slots)
    owner_c, _, edge_id, valid, start, end = (np.asarray(a) for a in rows)
    if slot_share < 1:
        assert end.max() > num_slots  # spans run past the buffer
    eid = np.clip(edge_id, 0, tg.m_pad - 1)
    dst_b = np.where(valid, np.asarray(jg.dst)[eid], tg.n_pad - 1)
    w_b = np.where(valid, np.asarray(jg.edge_w)[eid], 0)
    labels = rng.integers(-1, k + 1, tg.n_pad).astype(np.int32)
    js = np.asarray(jseg.dense_block_ratings(
        jnp.asarray(owner_c), jnp.asarray(dst_b), jnp.asarray(w_b),
        jnp.asarray(labels), tg.n_pad, k,
    ))
    port_rows = T.expand_active_rows(tg.row_ptr, tg.degrees, tt(active),
                                     num_slots)
    np.testing.assert_array_equal(port_rows[4].numpy(), start)
    out = gather.dense_block_ratings(
        tt(start), tt(end), tt(dst_b.astype(np.int32)),
        tt(w_b.astype(np.int32)), tt(labels), tg.n_pad, k,
    ).numpy()
    np.testing.assert_array_equal(js, out)


# ---------------------------------------------------------------- K3


def _slot_tables(jg, tg, num_slots, salt, label_space, seed):
    rng = np.random.default_rng(seed)
    labels = np.arange(tg.n_pad, dtype=np.int32)
    labels[: tg.n] = rng.integers(0, label_space, tg.n)
    nb = labels[np.asarray(jg.dst)]
    jt = jrating.scatter_slot_ratings(jg.src, jnp.asarray(nb), jg.edge_w,
                                      tg.n_pad, num_slots, salt)
    tt_ = rating.scatter_slot_ratings(tg.src, tt(nb), tg.edge_w, tg.n_pad,
                                      num_slots, salt)
    for a, b in zip(jt, tt_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return labels, [np.asarray(a) for a in jt]


@pytest.mark.parametrize("num_slots", [8, 32])
@pytest.mark.parametrize("salt", [13, -5, 0x7FFFFFFF])
def test_k3_matches_pallas_unconstrained(graphs, num_slots, salt):
    jg, tg = graphs
    labels, (slot_label, slot_w, _) = _slot_tables(
        jg, tg, num_slots, 13, tg.n, num_slots
    )
    jout = jrating.best_from_slots_pallas(
        jnp.asarray(slot_label), jnp.asarray(slot_w), jnp.asarray(labels),
        np.int32(salt), interpret=True,
    )
    zeros = torch.zeros(tg.n_pad, dtype=torch.int32)
    before = rating.best_from_slots.launches
    tout = rating.best_from_slots(
        tt(slot_label), tt(slot_w), tt(labels), zeros, tg.node_w, zeros,
        salt, require_fit=False,
    )
    assert rating.best_from_slots.launches == before
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("cap_value", [1, 6, 40])
def test_k3_matches_masked_best_from_slots(graphs, cap_value):
    """With require_fit the feasibility mask (cluster weight + node weight
    <= cap, wrapping int32) is folded into K3's reduction."""
    jg, tg = graphs
    labels, (slot_label, slot_w, _) = _slot_tables(jg, tg, 32, 77, 300, 1)
    rng = np.random.default_rng(cap_value)
    cw = rng.integers(0, 10, tg.n_pad).astype(np.int32)
    cw[:3] = [np.iinfo(np.int32).max, 2**31 - 2, 0]  # wraps past the cap
    cap = np.full(tg.n_pad, cap_value, dtype=np.int32)
    node_w = np.asarray(jg.node_w)
    jout = jrating.best_from_slots(
        jnp.asarray(slot_label), jnp.asarray(slot_w), jnp.asarray(labels),
        jnp.asarray(cw), jnp.asarray(node_w), jnp.asarray(cap), 991,
    )
    tout = rating.best_from_slots(
        tt(slot_label), tt(slot_w), tt(labels), tt(cw), tt(node_w), tt(cap),
        991,
    )
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_k3_twin_supports_communities_and_label_range(graphs):
    jg, tg = graphs
    labels, (slot_label, slot_w, _) = _slot_tables(jg, tg, 16, 5, 200, 2)
    rng = np.random.default_rng(4)
    comm = rng.integers(0, 3, tg.n_pad).astype(np.int32)
    cw = np.zeros(tg.n_pad, dtype=np.int32)
    cap = np.full(tg.n_pad, 100, dtype=np.int32)
    node_w = np.asarray(jg.node_w)
    jout = jrating.best_from_slots(
        jnp.asarray(slot_label), jnp.asarray(slot_w), jnp.asarray(labels),
        jnp.asarray(cw), jnp.asarray(node_w), jnp.asarray(cap), 3,
        communities=jnp.asarray(comm),
        label_range=(jnp.int32(20), jnp.int32(150)),
    )
    tout = rating.best_from_slots(
        tt(slot_label), tt(slot_w), tt(labels), tt(cw), tt(node_w), tt(cap),
        3, communities=tt(comm), label_range=(20, 150),
    )
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_scatter_slot_ratings_with_spans_and_valid(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 400, tg.n_pad).astype(np.int32)
    nb = labels[np.asarray(jg.dst)]
    valid = rng.random(tg.m_pad) < 0.8
    spans = (np.asarray(jg.row_ptr)[:-1], np.asarray(jg.row_ptr)[1:])
    jout = jrating.scatter_slot_ratings(
        jg.src, jnp.asarray(nb), jg.edge_w, tg.n_pad, 16, jnp.int32(-9),
        valid=jnp.asarray(valid),
        spans=tuple(jnp.asarray(s) for s in spans),
    )
    tout = rating.scatter_slot_ratings(
        tg.src, tt(nb), tg.edge_w, tg.n_pad, 16, -9, valid=tt(valid),
        spans=tuple(tt(s) for s in spans),
    )
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("rating_name", ["auto", "sort", "hash"])
@pytest.mark.parametrize(
    "num_clusters,n,m,avg,skew",
    [(100, 100, 800, None, None), (5000, 5000, 60000, None, None),
     (5000, 5000, 60000, 12.0, 20.0), (5000, 5000, 60000, 40.0, 20.0),
     (5000, 5000, 60000, 12.0, 5000.0), (1 << 23, 1 << 23, 1 << 26, 8.0,
                                         30.0)],
)
def test_select_engine_copy(rating_name, num_clusters, n, m, avg, skew):
    for row_spans in (True, False):
        assert jrating.select_engine(
            rating_name, num_clusters, n, m, avg_degree=avg,
            degree_skew=skew, row_spans=row_spans,
        ) == rating.select_engine(
            rating_name, num_clusters, n, m, avg_degree=avg,
            degree_skew=skew, row_spans=row_spans,
        )


# ------------------------------------------------- wrappers off the CPU


class _KernelPathTaken(Exception):
    pass


def test_wrappers_never_take_the_twin_off_cpu(monkeypatch):
    """On a tensor that is not on the CPU a wrapper goes to its kernel (or
    raises); it never falls back to the twin.  Meta tensors stand in for
    CUDA ones, and binding the kernel is intercepted."""

    def no_bind(*_a, **_k):
        raise _KernelPathTaken

    monkeypatch.setattr(_native, "bind", no_bind)
    meta = torch.zeros(512, dtype=torch.int32, device="meta")
    with pytest.raises(_KernelPathTaken):
        gather.gather_i32(meta, meta)
    with pytest.raises(_KernelPathTaken):
        gather.dense_block_ratings(meta, meta, meta, meta, meta, 512, 4)
    with pytest.raises(ValueError):  # spans must have one entry per row
        gather.dense_block_ratings(meta[:8], meta[:8], meta, meta, meta,
                                   512, 4)
    slots = torch.zeros((512, 64), dtype=torch.int32, device="meta")
    with pytest.raises(_KernelPathTaken):
        rating.best_from_slots(slots, slots, meta, meta, meta, meta, 1)
    with pytest.raises(_KernelPathTaken):  # the masks reach the kernel
        rating.best_from_slots(slots, slots, meta, meta, meta, meta, 1,
                               communities=meta, label_range=(0, 256))
    with pytest.raises(_KernelPathTaken):  # a ghost-extended label table
        gather.dense_block_ratings(meta[:256], meta[:256], meta, meta, meta,
                                   256, 4)
    with pytest.raises(TypeError):
        gather.gather_i32(meta, meta.to(torch.int64))


def test_kernel_sources_name_what_they_replace():
    for src, replaced in (
        ("gather.cu", "lane_gather"),
        ("dense_ratings.cu", "lane_gather"),
        ("best_from_slots.cu", "best_from_slots_pallas"),
    ):
        text = (_native.CSRC_DIR / src).read_text()
        assert src in _native.SOURCES
        assert replaced in text
        assert "Bound on the H100" in text
        assert "cudaGetLastError" in text


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    """Each CUDA kernel against its twin on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and run the "
                    "CUDA kernels")
    dev = torch.device("cuda")
    jg = jax_upload(jfactories.make_rmat(1 << 12, 40000, seed=2))
    g = device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device=dev,
    )
    gen = np.random.default_rng(0)
    labels = labels_from_numpy(gen.integers(0, g.n_pad, g.n_pad), dev)
    assert torch.equal(gather.gather_i32(labels, g.dst),
                       gather.gather_i32_twin(labels, g.dst))
    # an odd length at every offset from a 16-byte boundary
    for off in range(4):
        idx = g.dst[off: off + 10_001]
        assert torch.equal(gather.gather_i32(labels, idx),
                           gather.gather_i32_twin(labels, idx))
    part = labels_from_numpy(gen.integers(-1, 17, g.n_pad), dev)
    spans = (g.row_ptr[:-1], g.row_ptr[1:])
    args = (*spans, g.dst, g.edge_w, part, g.n_pad, 16)
    assert torch.equal(gather.dense_block_ratings(*args),
                       gather.dense_block_ratings_twin(*args))
    # a hub row of 45k edges beside short rows, at k inside and beyond the
    # shared-memory design (k <= 2048), with n_pad * k within 2^28
    deg = gen.integers(0, 8, 4096)
    deg[5], deg[3000] = 45_000, 41_000
    deg[-100:] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(row_ptr[-1])
    hub_dst = labels_from_numpy(gen.integers(0, 4096, m + 77), dev)
    hub_w = labels_from_numpy(gen.integers(0, 5, m + 77), dev)
    hub_spans = tuple(labels_from_numpy(a, dev)
                      for a in (row_ptr[:-1], row_ptr[1:]))
    for k in (2, 16, 256, 2048, 4096):
        lab = labels_from_numpy(gen.integers(-1, k + 1, 4096), dev)
        hub = (*hub_spans, hub_dst, hub_w, lab, 4096, k)
        assert torch.equal(gather.dense_block_ratings(*hub),
                           gather.dense_block_ratings_twin(*hub))
    nb = gather.gather_i32(labels, g.dst)
    sl, sw, _ = rating.scatter_slot_ratings(g.src, nb, g.edge_w, g.n_pad,
                                            32, 7)
    # cluster weights around the cap (unit node weights: a third of the
    # labels is infeasible) and some at INT32_MAX, where the add wraps
    i32_max = np.iinfo(np.int32).max
    cw_np = gen.integers(1, 4, g.n_pad).astype(np.int32)
    cw_np[::37] = i32_max
    cw = labels_from_numpy(cw_np, dev)
    cap = torch.full((g.n_pad,), 3, dtype=torch.int32, device=dev)
    best = {}
    for fit in (True, False):
        a = rating.best_from_slots(sl, sw, labels, cw, g.node_w, cap, -11,
                                   require_fit=fit)
        b = rating.best_from_slots_twin(sl, sw, labels, cw, g.node_w, cap,
                                        -11, require_fit=fit)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        best[fit] = a[0]
    assert (best[True] != best[False]).any()
    chosen = best[True]
    assert ((chosen >= 0) & (cw[chosen.clamp(min=0)] == i32_max)).any()
