"""The fused K3 (rating.scatter_best_from_slots) against the JAX package's
scatter engine: scatter_slot_ratings followed by best_from_slots, composed
as kaminpar_tpu/ops/lp.py composes them in the LP round and in two-hop
clustering.

On the CPU the wrapper runs its plain torch twin, so these tests hold the
twin's arithmetic bitwise against the JAX functions.  The CUDA kernel is
held against the twin by the `cuda`-marked test at the end, which needs
an NVIDIA card and skips elsewhere, and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.ops import rating as jrating
from kaminpar_tpu.ops import segments as jseg
from kaminpar_tpu_torch import _native
from kaminpar_tpu_torch.convert import device_graph_from_arrays
from kaminpar_tpu_torch.ops import rating
from kaminpar_tpu_torch.ops import segments as T
from torch_threads import one_torch_thread  # noqa: F401

I32_MAX = np.iinfo(np.int32).max
CAP = 6


def tt(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def port_graph(jg):
    return device_graph_from_arrays(
        *(np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                  jg.node_w)),
        int(jg.n), int(jg.m), device="cpu",
    )


@pytest.fixture(scope="module")
def graphs():
    jg = jax_upload(jfactories.make_rmat(1 << 12, 30_000, seed=3))
    return jg, port_graph(jg)


def _labels(tg, kind, seed):
    labels = np.arange(tg.n_pad, dtype=np.int32)
    if kind == "random":
        labels[: tg.n] = np.random.default_rng(seed).integers(
            0, tg.n // 3, tg.n)
    return labels


def _weights(tg, seed):
    """Cluster weights in [CAP - 2, CAP] (unit node weights: a third of the
    labels is infeasible), every 37th at INT32_MAX, where cw + node_w wraps
    negative in int32 and so passes the mask."""
    cw = np.random.default_rng(seed).integers(CAP - 2, CAP + 1, tg.n_pad)
    cw = cw.astype(np.int32)
    cw[::37] = I32_MAX
    return cw, np.full(tg.n_pad, CAP, dtype=np.int32)


def _jax(owner, nb, w, labels, cw, node_w, cap, n_pad, num_slots, salt,
         require_fit, valid=None, spans=None, communities=None):
    """The JAX composition: scatter_slot_ratings, then best_from_slots
    with the round's salt as tie salt (lp.py)."""
    j = jnp.asarray
    salt = jnp.int32(salt)
    slot_label, slot_w, fully_rated = jrating.scatter_slot_ratings(
        j(owner), j(nb), j(w), n_pad, num_slots, salt,
        valid=None if valid is None else j(valid),
        spans=None if spans is None else tuple(j(s) for s in spans),
    )
    best, best_w, w_own = jrating.best_from_slots(
        slot_label, slot_w, j(labels), j(cw), j(node_w), j(cap), salt,
        require_fit=require_fit,
        communities=None if communities is None else j(communities),
    )
    return [np.asarray(a) for a in (best, best_w, w_own, fully_rated)]


def _port(start, end, dst_b, w_b, labels, cw, node_w, cap, num_slots, salt,
          require_fit, communities=None):
    before = rating.scatter_best_from_slots.launches
    out = rating.scatter_best_from_slots(
        tt(start), tt(end), tt(dst_b), tt(w_b), tt(labels), tt(cw),
        tt(node_w), tt(cap), num_slots, salt, require_fit=require_fit,
        communities=None if communities is None else tt(communities),
    )
    assert rating.scatter_best_from_slots.launches == before  # the twin
    assert out[3].dtype == torch.bool
    return [a.numpy() for a in out]


def _same(jout, tout):
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["ids", "random"])
@pytest.mark.parametrize("salt", [12345, -7])
@pytest.mark.parametrize("num_slots", [4, 32, 64])
def test_full_round_matches_jax_composition(graphs, num_slots, salt, kind):
    """A full LP round: the COO edges (graph.src) with the CSR spans, as
    kaminpar_tpu/ops/lp.py rates them, against the twin over the spans;
    the feasibility mask on and off."""
    jg, tg = graphs
    labels = _labels(tg, kind, num_slots)
    cw, cap = _weights(tg, salt & 0xFF)
    row_ptr, src, dst, w, node_w = (
        np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                jg.node_w)
    )
    spans = (row_ptr[:-1], row_ptr[1:])
    best = {}
    for fit in (True, False):
        jout = _jax(src, labels[dst], w, labels, cw, node_w, cap, tg.n_pad,
                    num_slots, salt, fit, spans=spans)
        tout = _port(*spans, dst, w, labels, cw, node_w, cap, num_slots,
                     salt, fit)
        _same(jout, tout)
        best[fit] = tout[0]
    fully_rated = tout[3]
    if num_slots == 4:  # contested rows, so the pass-2 path is exercised
        assert (~fully_rated[: tg.n]).sum() > 100
    assert (best[True] != best[False]).any()  # the mask changed rows
    chosen = best[True]
    assert ((chosen >= 0) & (cw[np.maximum(chosen, 0)] == I32_MAX)).any()


@pytest.mark.parametrize("num_slots", [4, 64])
def test_communities_match_jax_composition(graphs, num_slots):
    """The v-cycle's community restriction (a 16-block partition as the
    communities): a full round's twin against the JAX composition with
    communities=, the feasibility mask on and off.  The mask must bar the
    best label of some rows."""
    jg, tg = graphs
    rng = np.random.default_rng(num_slots)
    communities = np.full(tg.n_pad, 15, dtype=np.int32)
    communities[: tg.n] = rng.integers(0, 16, tg.n)
    labels = _labels(tg, "random", 21)
    cw, cap = _weights(tg, 4)
    row_ptr, src, dst, w, node_w = (
        np.asarray(a) for a in (jg.row_ptr, jg.src, jg.dst, jg.edge_w,
                                jg.node_w)
    )
    spans = (row_ptr[:-1], row_ptr[1:])
    for fit in (True, False):
        free = _port(*spans, dst, w, labels, cw, node_w, cap, num_slots, 77,
                     fit)
        jout = _jax(src, labels[dst], w, labels, cw, node_w, cap, tg.n_pad,
                    num_slots, 77, fit, spans=spans, communities=communities)
        tout = _port(*spans, dst, w, labels, cw, node_w, cap, num_slots, 77,
                     fit, communities=communities)
        _same(jout, tout)
        assert (tout[0] != free[0]).sum() > 100
        np.testing.assert_array_equal(tout[2], free[2])  # w_own
        np.testing.assert_array_equal(tout[3], free[3])  # fully_rated


@pytest.mark.parametrize("slot_share", [0.3, 1.5])
@pytest.mark.parametrize("num_slots", [4, 64])
def test_delta_round_spans_cut_at_the_buffer(graphs, num_slots, slot_share):
    """A delta round: the active rows compacted into a buffer whose spans
    (expand_active_rows) run past its end when the buffer is short; the
    JAX side rates the buffer's valid slots by owner, the twin the spans
    cut at the buffer."""
    jg, tg = graphs
    rng = np.random.default_rng(num_slots + int(10 * slot_share))
    active = rng.random(tg.n_pad) < 0.4
    degrees = np.diff(np.asarray(jg.row_ptr))
    buf = max(1, int(slot_share * degrees[active].sum()))
    rows = jseg.expand_active_rows(jg.row_ptr, jnp.asarray(degrees),
                                   jnp.asarray(active), buf)
    owner_c, _, edge_id, valid, start, end = (np.asarray(a) for a in rows)
    if slot_share < 1:
        assert end.max() > buf  # spans run past the buffer
    port_rows = T.expand_active_rows(tg.row_ptr, tg.degrees,
                                     torch.from_numpy(active), buf)
    np.testing.assert_array_equal(port_rows[4].numpy(), start)
    np.testing.assert_array_equal(port_rows[5].numpy(), end)
    eid = np.clip(edge_id, 0, tg.m_pad - 1)
    dst_b = np.where(valid, np.asarray(jg.dst)[eid], tg.n_pad - 1)
    w_b = np.where(valid, np.asarray(jg.edge_w)[eid], 0)
    labels = _labels(tg, "random", 5)
    cw, cap = _weights(tg, 9)
    node_w = np.asarray(jg.node_w)
    nb = np.where(valid, labels[dst_b], -1)
    for fit in (True, False):
        jout = _jax(owner_c, nb, w_b, labels, cw, node_w, cap, tg.n_pad,
                    num_slots, 99, fit, valid=valid, spans=(start, end))
        tout = _port(start, end, dst_b, w_b, labels, cw, node_w, cap,
                     num_slots, 99, fit)
        _same(jout, tout)


@pytest.mark.parametrize("salt", [12345, -7])
@pytest.mark.parametrize("num_slots", [4, 32, 64])
def test_two_hop_form_without_spans_equals_span_form(graphs, num_slots,
                                                     salt):
    """Two-hop clustering in the JAX package rates the whole COO list
    (graph.src, pad edges included, no spans; lp.py:1035-1045); the port
    rates the CSR spans.  The pad edges only reach the pad row, and every
    output is bitwise the same, pad row included."""
    jg, tg = graphs
    node_w, src, dst, w = (np.asarray(a) for a in (jg.node_w, jg.src,
                                                   jg.dst, jg.edge_w))
    assert tg.m_pad > tg.m  # the COO form has pad edges
    cw, cap = _weights(tg, 3)
    for kind in ("ids", "random"):
        labels = _labels(tg, kind, 11)
        jout = _jax(src, labels[dst], w, labels, cw, node_w, cap, tg.n_pad,
                    num_slots, salt, False)
        row_ptr = np.asarray(jg.row_ptr)
        tout = _port(row_ptr[:-1], row_ptr[1:], dst, w, labels, cw, node_w,
                     cap, num_slots, salt, False)
        _same(jout, tout)
        if num_slots == 4:
            assert not tout[3][: tg.n].all()


class _KernelPathTaken(Exception):
    pass


def test_dispatch_cpu_twin_and_card_path(graphs, monkeypatch):
    """The CPU takes the twin (no launch); a tensor elsewhere goes to the
    kernel or raises, and never falls back to the twin.  Meta tensors stand
    in for CUDA ones, and binding the kernel is intercepted."""
    jg, tg = graphs
    spans = (tg.row_ptr[:-1], tg.row_ptr[1:])
    cw = torch.zeros(tg.n_pad, dtype=torch.int32)
    args = (*spans, tg.dst, tg.edge_w, tg.node_ids(), cw, tg.node_w, cw)
    before = rating.scatter_best_from_slots.launches
    out = rating.scatter_best_from_slots(*args, 32, 5)
    assert rating.scatter_best_from_slots.launches == before
    for a, b in zip(out, rating.scatter_best_from_slots_twin(*args, 32, 5)):
        assert torch.equal(a, b)

    def no_bind(*_a, **_k):
        raise _KernelPathTaken

    monkeypatch.setattr(_native, "bind", no_bind)
    meta = torch.zeros(512, dtype=torch.int32, device="meta")
    margs = (meta,) * 8
    with pytest.raises(_KernelPathTaken):
        rating.scatter_best_from_slots(*margs, 64, 5)
    with pytest.raises(_KernelPathTaken):  # communities= takes the kernel
        rating.scatter_best_from_slots(*margs, 64, 5, communities=meta)
    with pytest.raises(ValueError):  # communities must have n_pad entries
        rating.scatter_best_from_slots(*margs, 64, 5, communities=meta[:8])
    with pytest.raises(ValueError):  # beyond the kernel's tables
        rating.scatter_best_from_slots(*margs, rating.MAX_FUSED_SLOTS + 1, 5)
    with pytest.raises(ValueError):  # spans must have one entry per row
        rating.scatter_best_from_slots(meta[:8], meta[:8], *margs[2:], 64, 5)
    with pytest.raises(TypeError):
        rating.scatter_best_from_slots(*margs[:4], meta.to(torch.int64),
                                       *margs[5:], 64, 5)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_fused_kernel_matches_twin_on_card():
    """The fused kernel against its twin on the same CUDA tensors: light
    rows beside hub rows of 45k edges (the block-per-row kernel), at the
    path's slot counts, at 4 (contested rows) and at 48 (no power of
    two), and with spans cut at a buffer that ends inside a hub row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and run the "
                    "CUDA kernels")
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    n = 1 << 13
    deg = gen.integers(0, 40, n)
    deg[[5, 3000]] = (45_000, 41_000)
    deg[[7, 8, 9]] = (256, 257, 1000)  # either side of the light limit
    deg[-100:] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    m = int(row_ptr[-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    dst = t(gen.integers(0, n, m + 77))
    w = t(gen.integers(0, 5, m + 77))
    node_w = t(np.ones(n))
    cw_np = gen.integers(CAP - 2, CAP + 1, n).astype(np.int32)
    cw_np[::37] = I32_MAX
    cw, cap = t(cw_np), t(np.full(n, CAP))
    spans = (t(row_ptr[:-1]), t(row_ptr[1:]))
    # the whole buffer, and one that ends inside the first hub's span
    buffers = ((dst, w), (dst[:30_000], w[:30_000]))
    communities = t(gen.integers(0, 16, n))
    for num_slots in (4, 32, 48, 64):  # 48 takes `%`, not a mask
        for label_range in (n, 300):
            labels = t(gen.integers(-1, label_range, n))
            for dst_b, w_b in buffers:
                for fit, comm in ((True, None), (False, None),
                                  (True, communities)):
                    args = (*spans, dst_b, w_b, labels, cw, node_w, cap,
                            num_slots, -11)
                    a = rating.scatter_best_from_slots(
                        *args, require_fit=fit, communities=comm)
                    b = rating.scatter_best_from_slots_twin(
                        *args, require_fit=fit, communities=comm)
                    torch.cuda.synchronize()
                    for x, y in zip(a, b):
                        assert torch.equal(x, y)
