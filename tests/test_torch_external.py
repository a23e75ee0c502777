"""The external (out-of-core) scheme against the JAX package, at zero
tolerance: the chunk plan, the CSR, compressed and generator sources and
their padded blocks, skagen's chunks, the streamed LP labels and the
streamed contraction's coarse graphs, chunk-count invariance, the spill
tier, the exactness of the cluster-weight cap on a node-weighted graph,
the memory estimators, and `external` end to end without a budget and
with one that halves the chunks and streams three levels (the JAX side
with its memory governor off, which the port does not have).
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.context import PartitioningMode as JMode
from kaminpar_tpu.external import chunkstore as jstore
from kaminpar_tpu.external import stream_coarsen as jsc
from kaminpar_tpu.graphs import compressed as jcomp
from kaminpar_tpu.graphs.factories import make_rmat
from kaminpar_tpu.graphs.host import HostGraph as JHostGraph
from kaminpar_tpu.io import skagen as jskagen
from kaminpar_tpu.resilience import memory as jmem
from kaminpar_tpu_torch.external import chunkstore as tstore
from kaminpar_tpu_torch.external import stream_coarsen as tsc
from kaminpar_tpu_torch.graphs import compressed as tcomp
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.io import skagen as tskagen
from kaminpar_tpu_torch.resilience import memory as tmem
from test_torch_schemes import port_context
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SPEC = "rmat;n=4096;m=30000;seed=3"


def _graphs(weighted_nodes=False):
    g = make_rmat(1 << 12, 30_000, seed=3)
    nw = None
    if weighted_nodes:
        nw = np.random.default_rng(9).integers(1, 6, g.n).astype(np.int64)
    return (JHostGraph(g.xadj, g.adjncy, nw, g.edge_weights),
            HostGraph(g.xadj, g.adjncy, nw, g.edge_weights))


def _stores(source, chunk_edges, spill_dir=""):
    jg, tg = _graphs()
    if source == "compressed":
        jg, tg = (jcomp.compress_host_graph(jg),
                  tcomp.compress_host_graph(tg))
    elif source == "spec":
        jg, tg = jstore.StreamedSpecGraph(SPEC), tstore.StreamedSpecGraph(SPEC)
    return (jstore.build_store(jg, chunk_edges),
            tstore.build_store(tg, chunk_edges, spill_dir=spill_dir))


@pytest.mark.parametrize("n,chunks", [(0, 1), (1, 4), (10, 3), (4096, 7),
                                      (4097, 64)])
def test_chunk_ranges_equal_jax(n, chunks):
    assert tstore.chunk_ranges(n, chunks) == jstore.chunk_ranges(n, chunks)


@pytest.mark.parametrize("source", ["csr", "compressed", "spec"])
@pytest.mark.parametrize("chunk_edges", [1 << 13, 1 << 22])
def test_chunk_blocks_equal_jax(source, chunk_edges):
    js, ts = _stores(source, chunk_edges)
    assert (ts.num_chunks, ts.span, ts.e_pad, ts.ranges) == (
        js.num_chunks, js.span, js.e_pad, js.ranges)
    assert ts.chunk_buffer_bytes() == js.chunk_buffer_bytes()
    blocks = [js.chunk_host(c) for c in range(js.num_chunks)]
    for c, jb in enumerate(blocks):
        tb = ts.chunk_host(c)
        assert (tb.v0, tb.v1, tb.m_real) == (jb.v0, jb.v1, jb.m_real)
        for f in ("src_local", "dst", "w"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert ts.decoded_bytes == js.decoded_bytes
    # the upload carries the real slots only
    for c, jb in enumerate(blocks):
        src_local, dst, w, v0, m_real = ts.upload(c, CPU)
        assert (v0, m_real) == (jb.v0, jb.m_real)
        assert isinstance(v0, int) and isinstance(m_real, int)
        np.testing.assert_array_equal(src_local.numpy(),
                                      jb.src_local[:m_real])
        np.testing.assert_array_equal(dst.numpy(), jb.dst[:m_real])
        np.testing.assert_array_equal(w.numpy(), jb.w[:m_real])
    assert ts.uploaded_bytes == 3 * 4 * ts.m


def _row_sorted(block):
    order = np.lexsort((block.dst, block.src_local))
    return [getattr(block, f)[order] for f in ("src_local", "dst", "w")]


def test_sources_agree():
    """The CSR, compressed and generator sources of one graph give the
    same padded chunks (the spec's graph, assembled, is the CSR here);
    the v2 codec gives each row's neighbors in its emit order."""
    spec_graph = tstore.StreamedSpecGraph(SPEC)
    host = spec_graph.to_host_graph()
    stores = [tstore.build_store(g, 1 << 13) for g in (
        host, tcomp.compress_host_graph(host, codec="gap"), spec_graph,
        tcomp.compress_host_graph(host, codec="v2"))]
    assert len({s.num_chunks for s in stores}) == 1
    assert stores[0].num_chunks > 1
    for c in range(stores[0].num_chunks):
        first = stores[0].chunk_host(c)
        for other in stores[1:3]:
            b = other.chunk_host(c)
            for f in ("src_local", "dst", "w"):
                np.testing.assert_array_equal(getattr(first, f),
                                              getattr(b, f))
        for a, b in zip(_row_sorted(first), _row_sorted(
                stores[3].chunk_host(c))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [SPEC, "gnm;n=3000;m=9000;seed=2",
                                  "rgg2d;n=2000;avg_degree=6.0;seed=5"])
@pytest.mark.parametrize("num_chunks", [1, 6])
def test_skagen_chunks_equal_jax(spec, num_chunks):
    js, ts = jskagen.streamed(spec, num_chunks), tskagen.streamed(
        spec, num_chunks)
    assert (ts.n, ts.num_chunks) == (js.n, js.num_chunks)
    for jc, tc in zip(js.chunks(), ts.chunks()):
        assert (tc.v_begin, tc.v_end) == (jc.v_begin, jc.v_end)
        for f in ("xadj", "adjncy", "adjwgt"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    jh, th = jskagen.hostgraph_from_stream(js), tskagen.hostgraph_from_stream(
        ts)
    np.testing.assert_array_equal(th.adjncy, jh.adjncy)
    np.testing.assert_array_equal(th.edge_weight_array(),
                                  jh.edge_weight_array())


def test_spec_graph_equals_jax():
    j, t = jstore.StreamedSpecGraph(SPEC), tstore.StreamedSpecGraph(SPEC)
    np.testing.assert_array_equal(t.xadj, j.xadj)
    assert (t.n, t.m, t.total_edge_weight) == (j.n, j.m, j.total_edge_weight)
    part = np.random.default_rng(1).integers(0, 4, t.n).astype(np.int32)
    a = tstore.streamed_partition_metrics(t, part, 4)
    b = jstore.streamed_partition_metrics(j, part, 4)
    assert a["cut"] == b["cut"]
    np.testing.assert_array_equal(a["block_weights"], b["block_weights"])


def _jax_lp(js, nw, cap, seed, rounds=3):
    labels, cw, node_w = jsc.make_vectors(js, nw)
    labels, cw, stats = jsc.stream_lp(js, labels, cw, node_w, cap, seed,
                                      rounds)
    return np.asarray(labels), np.asarray(cw), stats


def _port_lp(ts, nw, cap, seed, rounds=3):
    labels, cw, node_w = tsc.make_vectors(ts, nw, CPU)
    labels, cw, stats = tsc.stream_lp(ts, labels, cw, node_w, cap, seed,
                                      rounds)
    return labels.numpy(), cw.numpy(), stats


@pytest.mark.parametrize("source", ["csr", "compressed"])
@pytest.mark.parametrize("chunk_edges", [1 << 13, 1 << 22])
@pytest.mark.parametrize("batch_edges", [tsc.BATCH_EDGES, 700])
def test_stream_lp_and_contract_equal_jax(source, chunk_edges, batch_edges,
                                          monkeypatch):
    """Also with each chunk's device passes cut into row-aligned batches
    of at most 700 edges (a few hubs have more and form their own)."""
    monkeypatch.setattr(tsc, "BATCH_EDGES", batch_edges)
    js, ts = _stores(source, chunk_edges)
    jl, jcw, jst = _jax_lp(js, None, 40, 11)
    tl, tcw, tst = _port_lp(ts, None, 40, 11)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tcw, jcw)
    assert (tst["rounds"], tst["moved"]) == (jst["rounds"], jst["moved"])
    labels = tl[: ts.n].astype(np.int64)
    jc, jmap, _ = jsc.stream_contract(js, labels, None)
    tc, tmap, _ = tsc.stream_contract(ts, labels, None, CPU)
    np.testing.assert_array_equal(tmap, jmap)
    np.testing.assert_array_equal(tc.xadj, jc.xadj)
    np.testing.assert_array_equal(tc.adjncy, jc.adjncy)
    np.testing.assert_array_equal(tc.node_weight_array(),
                                  jc.node_weight_array())
    np.testing.assert_array_equal(tc.edge_weight_array(),
                                  jc.edge_weight_array())


def test_row_batches_cover_each_chunk():
    _, ts = _stores("csr", 1 << 13)
    for c in range(ts.num_chunks):
        v0, v1 = ts.ranges[c]
        batches = ts.row_batches(c, 500)
        assert len(batches) > 1
        rows = [(r0, r1) for r0, r1, _, _ in batches]
        assert rows[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        deg = np.diff(ts.source.xadj[v0: v1 + 1])
        assert not deg[rows[-1][1]:].any()
        for r0, r1, e0, e1 in batches:
            assert e1 - e0 == deg[r0:r1].sum()
            assert e1 - e0 <= 500 or r1 == r0 + 1
        assert batches[-1][3] == ts.chunk_edges(c)


def test_stream_lp_is_chunk_count_invariant():
    _, tg = _graphs()
    results = []
    for chunk_edges in (1 << 11, 1 << 13, 1 << 16):
        ts = tstore.build_store(tg, chunk_edges)
        results.append((ts.num_chunks, _port_lp(ts, None, 40, 5)[0][:tg.n]))
    assert len({c for c, _ in results}) == 3
    for _, labels in results[1:]:
        np.testing.assert_array_equal(labels, results[0][1])


def test_cap_is_exact_on_a_weighted_graph():
    jg, tg = _graphs(weighted_nodes=True)
    cap = 23
    ts, js = tstore.build_store(tg, 1 << 13), jstore.build_store(jg, 1 << 13)
    tl, tcw, _ = _port_lp(ts, tg.node_weights, cap, 3)
    jl, _, _ = _jax_lp(js, jg.node_weights, cap, 3)
    np.testing.assert_array_equal(tl, jl)
    weights = np.bincount(tl[: tg.n], weights=tg.node_weights,
                          minlength=len(tcw)).astype(np.int64)
    np.testing.assert_array_equal(weights[: tg.n], tcw[: tg.n])
    assert weights.max() <= cap
    assert (weights == cap).any()  # the cap binds


def test_spill_tier_reads_back_the_same_chunks(tmp_path):
    _, plain = _stores("compressed", 1 << 13)
    _, spilled = _stores("compressed", 1 << 13, spill_dir=str(tmp_path))
    first = _port_lp(spilled, None, 40, 7)[0]
    assert spilled.spilled_bytes > 0
    files = sorted(p.name for p in tmp_path.glob("chunk-*.npz"))
    assert len(files) == spilled.num_chunks
    np.testing.assert_array_equal(first, _port_lp(plain, None, 40, 7)[0])
    # a second store over the same plan reads the files back
    _, again = _stores("compressed", 1 << 13, spill_dir=str(tmp_path))
    np.testing.assert_array_equal(_port_lp(again, None, 40, 7)[0], first)
    assert again.spilled_bytes == 0
    # another plan drops the stale files
    _stores("compressed", 1 << 12, spill_dir=str(tmp_path))
    assert not list(tmp_path.glob("chunk-*.npz"))


def test_memory_estimators_equal_jax(monkeypatch):
    for n, m, k in ((0, 0, 1), (4096, 49_454, 8), (572_702, 19_074_100, 16),
                    (61_295, 5_976_698, 16)):
        assert tmem.padded_bucket(n, m, k) == jmem.padded_bucket(n, m, k)
        assert tmem.estimate_run_bytes(n, m, k) == jmem.estimate_run_bytes(
            n, m, k)
        for chunk in (1 << 15, 1 << 21, 1 << 22):
            assert (tmem.estimate_stream_bytes(n, chunk, k)
                    == jmem.estimate_stream_bytes(n, chunk, k))
        assert tmem.min_streamable_bytes(n, k) == jmem.min_streamable_bytes(
            n, k)
    n_pad, m_pad, _ = tmem.padded_bucket(10, 20, 2)
    assert tmem.device_csr_bytes(n_pad, m_pad) == jmem.device_csr_bytes(
        n_pad, m_pad)
    assert tmem.estimate_run_bytes(572_702, 19_074_100, 16) == 765_461_510
    assert tmem.estimate_run_bytes(61_295, 5_976_698, 16) == 186_254_342
    assert tmem.estimate_stream_bytes(572_702, 1 << 22, 16) == 112_118_360
    assert tmem.estimate_stream_bytes(572_702, 1 << 21, 16) == 61_786_712
    ctx = kp.context_from_preset("default")
    monkeypatch.delenv(tmem.ENV_BUDGET, raising=False)
    assert tmem.budget_bytes(ctx) is None
    monkeypatch.setenv(tmem.ENV_BUDGET, "123456789")
    assert tmem.budget_bytes(ctx) == 123456789
    ctx.resilience.memory_budget = float(96 << 20)
    assert tmem.budget_bytes(ctx) == 96 << 20


def _run_external(configure, host, k=8):
    jctx = kt.presets.create_context_by_preset_name("default")
    jctx.coarsening.contraction_limit = 160
    jctx.partitioning.mode = JMode.EXTERNAL
    configure(jctx)
    tctx = port_context(jctx)
    solver = kt.KaMinPar(jctx)
    solver.set_output_level(0)
    jpart = np.asarray(solver.set_graph(host).compute_partition(
        k=k, epsilon=0.03, seed=1))
    tsolver = kp.KaMinPar(tctx, device="cpu")
    tpart = tsolver.set_graph(
        HostGraph(host.xadj, host.adjncy, host.node_weights,
                  host.edge_weights)).compute_partition(
        k=k, epsilon=0.03, seed=1)
    return jpart, tpart, tsolver.last_external


@pytest.mark.parametrize("chunk_edges", [1 << 13, 1 << 22])
def test_external_bitwise_equal(chunk_edges):
    def configure(ctx):
        ctx.external.chunk_edges = chunk_edges

    jpart, tpart, record = _run_external(configure, _graphs()[0])
    np.testing.assert_array_equal(jpart, tpart)
    assert record["streamed_levels"] == 1
    assert record["fine_device_resident_bytes"] == 0
    assert record["chunks_total"] == (7 if chunk_edges == 1 << 13 else 1)


def test_external_with_a_budget_bitwise_equal(monkeypatch):
    """A 900,000-byte budget halves the 2^22-edge chunk target down to the
    2^15 floor (2 chunks) and streams three levels before the estimate of
    the coarse level fits 80% of it."""
    monkeypatch.setenv(jmem.ENV_GOVERNOR, "0")

    def configure(ctx):
        ctx.resilience.memory_budget = 900_000.0

    jpart, tpart, record = _run_external(configure, _graphs()[0])
    np.testing.assert_array_equal(jpart, tpart)
    assert record["streamed_levels"] == 3
    assert [lv["chunks"] for lv in record["levels"]] == [2, 1, 1]
    assert record["levels"][0]["chunk_edges"] == 1 << 15


def test_contraction_accumulator_dedups_on_the_way():
    """Folding the read-back groups with intermediate dedups (a small
    limit) gives the final dedup of all of them at once."""
    rng = np.random.default_rng(3)
    parts = [(torch.from_numpy(rng.integers(-1, 50, 400).astype(np.int32)),
              torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32)),
              torch.from_numpy(rng.integers(1, 9, 400).astype(np.int32)))
             for _ in range(7)]
    results = []
    for limit in (10 ** 9, 500):
        acc = tsc._Accumulator(50, limit)
        stats = {"drain_s": 0.0}
        for groups in parts:
            acc.absorb(groups, stats)
        results.append(acc.result())
    keys = np.concatenate([(cu.numpy()[cu.numpy() >= 0].astype(np.int64) * 50
                            + cv.numpy()[cu.numpy() >= 0])
                           for cu, cv, _ in parts])
    weights = np.concatenate([w.numpy()[cu.numpy() >= 0]
                              for cu, _, w in parts]).astype(np.int64)
    expect_k = np.unique(keys)
    expect_w = np.array([weights[keys == k].sum() for k in expect_k])
    for k, w in results:
        np.testing.assert_array_equal(k, expect_k)
        np.testing.assert_array_equal(w, expect_w)


def test_external_partition_entry(monkeypatch):
    """The functional entry runs on the card unless asked for the CPU, and
    gives the facade's partition on a graph without isolated nodes."""
    from kaminpar_tpu_torch.external import external_partition
    from kaminpar_tpu_torch.graphs.host import remove_isolated_nodes

    core, _, _ = remove_isolated_nodes(_graphs()[1])
    ctx = kp.context_from_preset("default")
    ctx.coarsening.contraction_limit = 160
    ctx.partitioning.mode = kp.context.PartitioningMode.EXTERNAL
    ctx.external.chunk_edges = 1 << 13
    facade = kp.KaMinPar(ctx, device="cpu").set_graph(core)
    expect = facade.compute_partition(k=4, epsilon=0.03, seed=2)
    np.testing.assert_array_equal(external_partition(core, ctx, "cpu"),
                                  expect)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        external_partition(core, ctx)


def test_external_on_a_generator_spec_bitwise_equal():
    """A StreamedSpecGraph through the facade: regenerated chunks, its
    isolated nodes kept in the stream, the gate's regenerated sweep."""
    spec = "rmat;n=2048;m=12000;seed=4"
    jctx = kt.presets.create_context_by_preset_name("default")
    jctx.coarsening.contraction_limit = 160
    jctx.partitioning.mode = JMode.EXTERNAL
    jctx.external.chunk_edges = 1 << 12
    tctx = port_context(jctx)
    solver = kt.KaMinPar(jctx)
    solver.set_output_level(0)
    jpart = np.asarray(solver.set_graph(jstore.StreamedSpecGraph(
        spec)).compute_partition(k=4, epsilon=0.03, seed=1))
    tsolver = kp.KaMinPar(tctx, device="cpu")
    tgraph = tstore.StreamedSpecGraph(spec)
    tpart = tsolver.set_graph(tgraph).compute_partition(
        k=4, epsilon=0.03, seed=1)
    np.testing.assert_array_equal(jpart, tpart)
    assert tsolver.last_external["chunks_total"] > 1
    assert tsolver.last_gate["valid"] and tsolver.last_gate["cut_match"]
    tctx.partitioning.mode = kp.context.PartitioningMode.DEEP
    with pytest.raises(ValueError, match="external scheme only"):
        kp.KaMinPar(tctx, device="cpu").set_graph(tgraph).compute_partition(
            k=4, epsilon=0.03, seed=1)
