"""Compressed graphs: the port's codecs write the JAX package's bytes (gap
and v2, with and without edge weights, native and numpy gap twins), and
its CompressedHostGraph decodes, compresses, re-encodes the isolated-free
core, sweeps the metrics and uploads chunk by chunk exactly as the JAX
package does — at zero tolerance.  Inputs: make_rmat graphs (isolated
nodes, merged duplicate edges as edge weights), node weights from a
seeded numpy generator, and rows shuffled out of order.
"""

import numpy as np
import pytest

from kaminpar_tpu import native as jnative
from kaminpar_tpu.graphs import compressed as jcomp
from kaminpar_tpu.graphs import csr as jcsr
from kaminpar_tpu.graphs.factories import make_rmat
from kaminpar_tpu.graphs.host import HostGraph as JHostGraph
from kaminpar_tpu.io import skagen as jskagen
from kaminpar_tpu.resilience import gate as jgate
from kaminpar_tpu_torch import native
from kaminpar_tpu_torch.graphs import compressed as tcomp
from kaminpar_tpu_torch.graphs.csr import (
    device_graph_from_compressed,
    device_graph_from_host,
)
from kaminpar_tpu_torch.graphs.host import HostGraph, host_partition_metrics
from kaminpar_tpu_torch.io import skagen as tskagen
from kaminpar_tpu_torch.resilience import gate as tgate
from torch_threads import one_torch_thread  # noqa: F401

CODECS = ["gap", "v2"]


def _graph(weighted_nodes=False, n_log=12, m=30_000, seed=3):
    g = make_rmat(1 << n_log, m, seed=seed)
    nw = None
    if weighted_nodes:
        nw = np.random.default_rng(seed).integers(1, 5, g.n).astype(np.int64)
    return (JHostGraph(g.xadj, g.adjncy, nw, g.edge_weights),
            HostGraph(g.xadj, g.adjncy, nw, g.edge_weights))


def _shuffled_rows(g):
    """The same graph with every row's neighbors in a seeded random order
    (the compressor must sort them)."""
    rng = np.random.default_rng(5)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    order = np.lexsort((rng.random(g.m), src))
    ew = None if g.edge_weights is None else g.edge_weights[order]
    return g.adjncy[order], ew


def _same_fields(a, b):
    for f in ("xadj", "offsets", "data", "node_weights", "edge_weights",
              "wdata", "woffsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
    assert a.codec == b.codec


@pytest.mark.parametrize("weighted", [False, True])
def test_codec_bytes_equal_jax(weighted):
    jg, tg = _graph()
    for j, t in ((jnative.encode_gaps(jg.xadj, jg.adjncy),
                  native.encode_gaps(tg.xadj, tg.adjncy)),
                 (jnative._encode_gaps_np(jg.n, jg.xadj, jg.adjncy),
                  native.encode_gaps_np(tg.xadj, tg.adjncy)),
                 (jnative.encode_v2(jg.xadj, jg.adjncy),
                  native.encode_v2(tg.xadj, tg.adjncy))):
        np.testing.assert_array_equal(j[0], t[0])
        np.testing.assert_array_equal(j[1], t[1])
    if weighted:
        ew = jg.edge_weights
        j = jnative.encode_v2_weights(jg.xadj, jg.adjncy, ew)
        t = native.encode_v2_weights(tg.xadj, tg.adjncy, ew)
        np.testing.assert_array_equal(j[0], t[0])
        np.testing.assert_array_equal(j[1], t[1])
        np.testing.assert_array_equal(
            native.decode_v2_weights(tg.xadj, t[1], t[0]),
            jnative.decode_v2_weights(jg.xadj, j[1], j[0]))
    data, off = native.encode_gaps(tg.xadj, tg.adjncy)
    np.testing.assert_array_equal(native.decode_gaps(tg.xadj, off, data),
                                  tg.adjncy)
    np.testing.assert_array_equal(
        native.decode_gaps_np(tg.xadj, off, data), tg.adjncy)
    data, off = native.encode_v2(tg.xadj, tg.adjncy)
    np.testing.assert_array_equal(
        native.decode_v2(tg.xadj, off, data),
        jnative.decode_v2(jg.xadj, off, data))
    for u in (0, 1, 17, tg.n - 1, int(np.argmax(tg.degrees()))):
        np.testing.assert_array_equal(
            native.decode_v2_node(u, tg.xadj, off, data),
            jnative.decode_v2_node(u, jg.xadj, off, data))


def test_gap_codec_without_gxx_is_the_numpy_twin(monkeypatch):
    _, tg = _graph(n_log=8, m=900)
    native_bytes = native.encode_gaps(tg.xadj, tg.adjncy)
    monkeypatch.setattr(native, "codec_enabled", lambda: False)
    twin = native.encode_gaps(tg.xadj, tg.adjncy)
    for a, b in zip(native_bytes, twin):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        native.decode_gaps(tg.xadj, twin[1], twin[0]), tg.adjncy)
    for u in range(0, tg.n, 37):
        np.testing.assert_array_equal(
            native.decode_node(u, tg.xadj, twin[1], twin[0]),
            tg.adjncy[tg.xadj[u]:tg.xadj[u + 1]])
    cg = tcomp.compress_host_graph(tg)
    assert cg.codec == "gap"


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("weighted_nodes", [False, True])
@pytest.mark.parametrize("shuffled", [False, True])
def test_compress_host_graph_equals_jax(codec, weighted_nodes, shuffled):
    jg, tg = _graph(weighted_nodes)
    if shuffled:
        adj, ew = _shuffled_rows(tg)
        jg = JHostGraph(jg.xadj, adj, jg.node_weights, ew)
        tg = HostGraph(tg.xadj, adj, tg.node_weights, ew)
    jc = jcomp.compress_host_graph(jg, codec=codec)
    tc = tcomp.compress_host_graph(tg, codec=codec)
    _same_fields(jc, tc)
    assert tc.total_edge_weight == jc.total_edge_weight
    assert tc.memory_bytes() == jc.memory_bytes()
    assert tc.compression_ratio() == jc.compression_ratio()
    jd, td = jc.decode(), tc.decode()
    for f in ("xadj", "adjncy"):
        np.testing.assert_array_equal(getattr(jd, f), getattr(td, f))
    np.testing.assert_array_equal(jd.edge_weight_array(),
                                  td.edge_weight_array())
    for u in (0, 5, tg.n // 2, tg.n - 1):
        np.testing.assert_array_equal(jc.neighbors(u), tc.neighbors(u))


@pytest.mark.parametrize("codec", CODECS)
def test_decode_range_equals_jax(codec):
    jg, tg = _graph()
    jc = jcomp.compress_host_graph(jg, codec=codec)
    tc = tcomp.compress_host_graph(tg, codec=codec)
    for v0, v1 in ((0, tg.n), (0, 1), (100, 100), (37, 1211),
                   (tg.n - 5, tg.n)):
        for a, b in zip(jc.decode_range(v0, v1), tc.decode_range(v0, v1)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        tc.decode_range(5, 2)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("chunk_nodes", [1 << 18, 1000])
def test_extract_core_compressed_equals_jax(codec, chunk_nodes):
    jg, tg = _graph(weighted_nodes=True)
    jcore, jids, jiso = jcomp.extract_core_compressed(
        jcomp.compress_host_graph(jg, codec=codec), chunk_nodes=chunk_nodes)
    tcore, tids, tiso = tcomp.extract_core_compressed(
        tcomp.compress_host_graph(tg, codec=codec), chunk_nodes=chunk_nodes)
    assert len(tiso) > 0
    _same_fields(jcore, tcore)
    np.testing.assert_array_equal(jids, tids)
    np.testing.assert_array_equal(jiso, tiso)


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_metrics_equal_jax_and_host(codec):
    jg, tg = _graph(weighted_nodes=True)
    tc = tcomp.compress_host_graph(tg, codec=codec)
    jc = jcomp.compress_host_graph(jg, codec=codec)
    part = np.random.default_rng(2).integers(0, 8, tg.n).astype(np.int32)
    t = tcomp.compressed_partition_metrics(tc, part, 8, chunk_nodes=1000)
    j = jcomp.compressed_partition_metrics(jc, part, 8, chunk_nodes=1000)
    h = host_partition_metrics(tg, part, 8)
    assert t["cut"] == j["cut"] == h["cut"]
    np.testing.assert_array_equal(t["block_weights"], j["block_weights"])
    assert t["imbalance"] == j["imbalance"]
    assert tgate.recompute_metrics(tc, part, 8)[0] == h["cut"]
    assert (tgate.recompute_metrics(tc, part, 8)[0]
            == jgate.recompute_metrics(jc, part, 8)[0])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("chunk_nodes", [1 << 18, 777])
@pytest.mark.parametrize("weighted_nodes", [False, True])
def test_device_graph_from_compressed_bitwise(codec, chunk_nodes,
                                              weighted_nodes):
    jg, tg = _graph(weighted_nodes)
    tc = tcomp.compress_host_graph(tg, codec=codec)
    streamed = device_graph_from_compressed(tc, "cpu",
                                            chunk_nodes=chunk_nodes)
    plain = device_graph_from_host(tc.decode(), "cpu")
    jdg = jcsr.device_graph_from_compressed(
        jcomp.compress_host_graph(jg, codec=codec), chunk_nodes=chunk_nodes)
    assert (streamed.n, streamed.m) == (plain.n, plain.m) == (tg.n, tg.m)
    for f in ("row_ptr", "src", "dst", "edge_w", "node_w"):
        a, b = getattr(streamed, f), getattr(plain, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jdg, f)),
                                      err_msg=f)
    pad = streamed.n_pad - 1
    assert (streamed.src[tg.m:] == pad).all()
    assert (streamed.dst[tg.m:] == pad).all()
    assert (streamed.edge_w[tg.m:] == 0).all()
    assert (streamed.node_w[tg.n:] == 0).all()
    assert (streamed.row_ptr[tg.n:] == tg.m).all()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("num_chunks", [1, 5])
def test_compress_from_stream_equals_jax(codec, num_chunks):
    spec = "rmat;n=2048;m=12000;seed=4"
    jc = jcomp.compress_from_stream(jskagen.streamed(spec, num_chunks),
                                    codec=codec)
    tc = tcomp.compress_from_stream(tskagen.streamed(spec, num_chunks),
                                    codec=codec)
    _same_fields(jc, tc)
    whole = tcomp.compress_host_graph(
        tskagen.hostgraph_from_stream(tskagen.streamed(spec, 1)),
        codec=codec)
    np.testing.assert_array_equal(tc.decode().adjncy, whole.decode().adjncy)
