"""Graph and partition files in the port: kaminpar_tpu_torch.io reads and
writes METIS, ParHiP (32- and 64-bit) and the compressed container as
kaminpar_tpu.io does.  Every file written by one package reads back in the
other to the same arrays, the METIS and ParHiP writers give the same bytes,
`load_graph` sniffs formats and applies the degree-bucket ordering as the
JAX package does, malformed inputs raise the same GraphFormatError,
message, line and byte offset alike, and a lazily loaded container
partitions to the JAX package's partition.  Graphs come from the JAX package's
factories, with isolated nodes and optional node and edge weights.
"""

import os
import zipfile

import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu import io as jio
from kaminpar_tpu.context import PartitioningMode
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.compressed import (
    compress_host_graph as jax_compress,
)
from kaminpar_tpu.graphs.host import HostGraph as JaxHostGraph
from kaminpar_tpu_torch import io as tio
from kaminpar_tpu_torch import load_graph
from kaminpar_tpu_torch.graphs.compressed import compress_host_graph
from kaminpar_tpu_torch.graphs.host import HostGraph
from test_torch_schemes import port_context
from torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = ("none", "node", "edge", "both")


def _graph(weights: str) -> JaxHostGraph:
    """make_rmat(2^10, 4000) (isolated nodes included), with random node
    weights and symmetric random edge weights as asked."""
    g = jfactories.make_rmat(1 << 10, 4000, seed=3)
    assert int((np.diff(g.xadj) == 0).sum()) > 0  # isolated nodes
    rng = np.random.default_rng(5)
    nw = ew = None
    if weights in ("node", "both"):
        nw = rng.integers(1, 9, g.n).astype(np.int64)
    if weights in ("edge", "both"):
        src = np.repeat(np.arange(g.n), np.diff(g.xadj))
        lo = np.minimum(src, g.adjncy).astype(np.int64)
        hi = np.maximum(src, g.adjncy).astype(np.int64)
        ew = ((lo * 7919 + hi * 104729) % 13 + 1).astype(np.int64)
    return JaxHostGraph(g.xadj, g.adjncy, nw, ew)


def _port(g) -> HostGraph:
    return HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)


def _assert_same_graph(a, b) -> None:
    assert np.array_equal(a.xadj, b.xadj)
    assert np.array_equal(a.adjncy, b.adjncy)
    for name in ("node_weights", "edge_weights"):
        wa, wb = getattr(a, name), getattr(b, name)
        assert (wa is None) == (wb is None), name
        if wa is not None:
            assert np.array_equal(wa, wb), name
            assert wa.dtype == wb.dtype, name
    assert a.xadj.dtype == b.xadj.dtype and a.adjncy.dtype == b.adjncy.dtype


@pytest.mark.parametrize("weights", WEIGHTS)
def test_metis_round_trip_both_ways_and_same_bytes(tmp_path, weights):
    g = _graph(weights)
    jpath, tpath = tmp_path / "j.metis", tmp_path / "t.metis"
    jio.write_metis(g, str(jpath))
    tio.write_metis(_port(g), str(tpath))
    assert jpath.read_bytes() == tpath.read_bytes()
    _assert_same_graph(tio.load_metis(str(jpath)), g)
    _assert_same_graph(jio.load_metis(str(tpath)), tio.load_metis(str(tpath)))
    # the Python parser too (the native tokenizer is load_metis's path)
    text = tpath.read_text()
    _assert_same_graph(tio.parse_metis(text), jio.parse_metis(text))


@pytest.mark.parametrize("use_32bit", [True, False])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_parhip_round_trip_both_ways_and_same_bytes(tmp_path, weights,
                                                    use_32bit):
    g = _graph(weights)
    jpath, tpath = tmp_path / "j.parhip", tmp_path / "t.parhip"
    jio.write_parhip(g, str(jpath), use_32bit=use_32bit)
    tio.write_parhip(_port(g), str(tpath), use_32bit=use_32bit)
    assert jpath.read_bytes() == tpath.read_bytes()
    _assert_same_graph(tio.load_parhip(str(jpath)), g)
    _assert_same_graph(jio.load_parhip(str(tpath)),
                       tio.load_parhip(str(tpath)))


def _compressed_members(cg) -> dict:
    return {name: getattr(cg, name) for name in (
        "xadj", "offsets", "data", "node_weights", "edge_weights", "wdata",
        "woffsets")}


def _assert_same_members(a, b) -> None:
    assert a.codec == b.codec
    ma, mb = _compressed_members(a), _compressed_members(b)
    for name in ma:
        assert (ma[name] is None) == (mb[name] is None), name
        if ma[name] is not None:
            assert np.array_equal(np.asarray(ma[name]),
                                  np.asarray(mb[name])), name


@pytest.mark.parametrize("codec", ["gap", "v2"])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_compressed_container_both_ways(tmp_path, weights, codec):
    g = _graph(weights)
    tcg = compress_host_graph(_port(g), codec=codec)
    jcg = jax_compress(g, codec=codec)
    _assert_same_members(tcg, jcg)
    tio.write_compressed(str(tmp_path / "t.npz"), tcg)
    jio.write_compressed(str(tmp_path / "j.npz"), jcg)
    _assert_same_members(jio.load_compressed(str(tmp_path / "t.npz")), tcg)
    loaded = tio.load_compressed(str(tmp_path / "j.npz"))
    _assert_same_members(loaded, jcg)
    _assert_same_graph(loaded.decode(), jcg.decode())
    assert tio.is_compressed_file(str(tmp_path / "j.npz"))
    assert jio.is_compressed_file(str(tmp_path / "t.npz"))


@pytest.mark.parametrize("compress", [False, True])
def test_lazy_compressed_load_maps_stored_members(tmp_path, compress):
    """A ZIP_STORED container loads lazily as np.memmap members; a
    deflated one cannot be mapped and loads eagerly, as in the JAX
    package.  Either way the arrays equal the eager load and the JAX
    package's lazy load."""
    g = _graph("both")
    cg = compress_host_graph(_port(g))
    path = str(tmp_path / "g.npz")
    tio.write_compressed(path, cg, compress=compress)
    with zipfile.ZipFile(path) as zf:
        stored = {i.compress_type for i in zf.infolist()}
    assert stored == ({zipfile.ZIP_DEFLATED} if compress
                      else {zipfile.ZIP_STORED})
    lazy = load_graph(path, lazy=True)
    mapped = [name for name, a in _compressed_members(lazy).items()
              if isinstance(a, np.memmap)]
    assert sorted(mapped) == ([] if compress else sorted(
        name for name, a in _compressed_members(cg).items()
        if a is not None and len(a)))
    _assert_same_members(lazy, cg)
    _assert_same_members(lazy, jio.load_compressed(path, lazy=True))
    # chunk-wise decoding reads the mapped streams in place
    xr, adj, ew = lazy.decode_range(100, 600)
    jxr, jadj, jew = cg.decode_range(100, 600)
    assert np.array_equal(xr, jxr) and np.array_equal(adj, jadj)
    assert np.array_equal(ew, jew)


@pytest.mark.parametrize("fmt", ["metis", "parhip"])
def test_degree_bucket_ordering(tmp_path, fmt):
    g = _graph("both")
    path = str(tmp_path / f"g.{fmt}")
    (jio.write_metis if fmt == "metis" else jio.write_parhip)(g, path)
    tg = load_graph(path, ordering="degree-buckets")
    _assert_same_graph(tg, jio.load_graph(path, ordering="degree-buckets"))
    deg = np.diff(tg.xadj)
    bucket = np.where(deg > 0, np.floor(np.log2(np.maximum(deg, 1))) + 1, 0)
    assert (np.diff(bucket) >= 0).all()
    with pytest.raises(ValueError, match="unknown node ordering"):
        load_graph(path, ordering="random")


def test_load_graph_sniffs_formats(tmp_path):
    """By extension, then by content: text is METIS, binary ParHiP, the
    magic member a compressed container; the ordering is refused for a
    container."""
    g = _graph("edge")
    jio.write_metis(g, str(tmp_path / "a"))
    jio.write_parhip(g, str(tmp_path / "b"))
    jio.write_compressed(str(tmp_path / "c"), jax_compress(g))
    os.replace(tmp_path / "c.npz", tmp_path / "c")
    for name in ("a", "b"):
        _assert_same_graph(load_graph(str(tmp_path / name)),
                           jio.load_graph(str(tmp_path / name)))
    _assert_same_members(load_graph(str(tmp_path / "c")),
                         jio.load_graph(str(tmp_path / "c")))
    with pytest.raises(ValueError, match="not supported for compressed"):
        load_graph(str(tmp_path / "c"), ordering="degree-buckets")
    with pytest.raises(ValueError, match="unknown graph format"):
        load_graph(str(tmp_path / "a"), fmt="xml")


def test_partition_files_same_bytes(tmp_path):
    rng = np.random.default_rng(2)
    part = rng.integers(0, 8, 300).astype(np.int32)
    perm = rng.permutation(300)
    for pkg, tag in ((jio, "j"), (tio, "t")):
        pkg.write_partition(str(tmp_path / f"{tag}.part"), part)
        pkg.write_block_sizes(str(tmp_path / f"{tag}.sizes"), part, 8)
        pkg.write_remapping(str(tmp_path / f"{tag}.map"), perm)
    for ext in ("part", "sizes", "map"):
        assert (tmp_path / f"j.{ext}").read_bytes() == (
            tmp_path / f"t.{ext}").read_bytes()
    assert np.array_equal(tio.read_partition(str(tmp_path / "j.part")), part)
    assert np.array_equal(tio.read_block_sizes(str(tmp_path / "j.sizes")),
                          np.bincount(part, minlength=8))


# ---------------------------------------------------------------------------
# malformed inputs: the cases of tests/test_io_malformed.py
# ---------------------------------------------------------------------------

METIS_CASES = [
    "",
    "4\n",
    "x 4\n2 3\n1 3\n1 2 4\n3\n",
    "-4 4\n",
    "4 999999\n2 3\n1 3\n1 2 4\n3\n",
    "4 4\n2 3\n1 3\n",
    "4 4\n2 3\n1 x\n1 2 4\n3\n",
    "4 4\n2 3\n1 99999999999999999999999\n1 2 4\n3\n",
    "4 4\n2 3\n1 3\n1 2 9\n3\n",
    "4 4\n2 3\n1 3\n1 2 0\n3\n",
    "4 5\n2 3\n1 3\n1 2 4\n3\n",
    "4 4 011\n2 3\n1 3\n1 2 4\n3\n",
    "4 4 10\n-1 2 3\n1 1 3\n1 1 2 4\n1 3\n",
    "% comment\n4 4\n2 3\n1 3\n1 2 bad\n3\n",
]


def _outcome(fn, *args):
    """('ok', graph) or ('error', type name, message, line, offset, path)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the type is compared too
        return ("error", type(e).__name__, str(e),
                getattr(e, "line", None), getattr(e, "offset", None),
                getattr(e, "path", None))


def _assert_same_outcome(a, b) -> None:
    assert a[0] == b[0], (a, b)
    if a[0] == "ok":
        _assert_same_graph(a[1], b[1])
    else:
        assert a == b


@pytest.mark.parametrize("case", range(len(METIS_CASES)))
def test_metis_malformed_same_errors(tmp_path, case):
    """Through the Python parser and through load_metis (the native
    tokenizer, the path attached to the error)."""
    text = METIS_CASES[case]
    out = _outcome(tio.parse_metis, text)
    assert out[0] == "error" and out[1] == "GraphFormatError"
    _assert_same_outcome(out, _outcome(jio.parse_metis, text))
    path = tmp_path / "broken.metis"
    path.write_text(text)
    _assert_same_outcome(_outcome(tio.load_metis, str(path)),
                         _outcome(jio.load_metis, str(path)))


def _parhip_bytes(tmp_path) -> bytes:
    path = tmp_path / "g.parhip"
    jio.write_parhip(jfactories.make_grid_graph(6, 6), str(path))
    return path.read_bytes()


def test_parhip_malformed_same_errors(tmp_path):
    data = _parhip_bytes(tmp_path)
    blobs = [b"\x00" * 10] + [data[:cut] for cut in
                              (30, len(data) // 2, len(data) - 4)]
    broken = bytearray(data)
    off = np.frombuffer(bytes(broken[24: 24 + 4 * 37]), dtype=np.uint32)
    off = off.copy()
    off[3], off[4] = off[10], off[2]
    broken[24: 24 + 4 * 37] = off.tobytes()
    blobs.append(bytes(broken))
    broken = bytearray(data)
    adj_start = 24 + 4 * 37
    broken[adj_start: adj_start + 4] = np.uint32(999).tobytes()
    blobs.append(bytes(broken))
    for blob in blobs:
        out = _outcome(tio.parse_parhip, blob)
        assert out[0] == "error" and out[1] == "GraphFormatError"
        _assert_same_outcome(out, _outcome(jio.parse_parhip, blob))


def test_fuzzed_files_same_outcome(tmp_path):
    """Seeded corruption and truncation of a METIS and a ParHiP file: the
    port parses what the JAX package parses, to the same arrays, and
    raises what it raises."""
    g = jfactories.make_grid_graph(8, 8)
    jio.write_metis(g, str(tmp_path / "f.metis"))
    base = (tmp_path / "f.metis").read_text()
    rng = np.random.default_rng(1234)
    junk = "x-%57 \n"
    for i in range(60):
        chars = list(base)
        for _ in range(int(rng.integers(1, 6))):
            chars[int(rng.integers(0, len(chars)))] = junk[
                int(rng.integers(0, len(junk)))]
        text = "".join(chars) if i % 2 else base[
            : int(rng.integers(0, len(base)))]
        _assert_same_outcome(_outcome(tio.parse_metis, text),
                             _outcome(jio.parse_metis, text))
        path = tmp_path / "fz.metis"
        path.write_text(text)
        _assert_same_outcome(_outcome(tio.load_metis, str(path)),
                             _outcome(jio.load_metis, str(path)))
    data = _parhip_bytes(tmp_path)
    rng = np.random.default_rng(4321)
    for i in range(60):
        blob = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        cut = int(rng.integers(0, len(data)))
        blob = bytes(blob) if i % 2 else data[:cut]
        _assert_same_outcome(_outcome(tio.parse_parhip, blob),
                             _outcome(jio.parse_parhip, blob))


@pytest.mark.parametrize("scheme", ["external", "deep"])
def test_partition_of_a_lazy_container_bitwise_equal(tmp_path, scheme):
    """A container written by the port, loaded lazily by each package and
    partitioned: `external` streams the mapped file (its core extraction
    reads it range by range), `deep` uploads it in chunks; the JAX
    package's partition, bitwise."""
    g = jfactories.make_rmat(1 << 12, 30_000, seed=3)
    path = str(tmp_path / "g.npz")
    tio.write_compressed(path, compress_host_graph(_port(g)), compress=False)
    jctx = kt.presets.create_context_by_preset_name("default")
    jctx.coarsening.contraction_limit = 160
    if scheme == "external":
        jctx.partitioning.mode = PartitioningMode.EXTERNAL
        jctx.external.chunk_edges = 1 << 13
    tctx = port_context(jctx)
    jsolver = kt.KaMinPar(jctx)
    jsolver.set_output_level(0)
    jpart = np.asarray(jsolver.set_graph(jio.load_graph(
        path, lazy=True)).compute_partition(k=4, epsilon=0.03, seed=1))
    lazy = load_graph(path, lazy=True)
    assert isinstance(lazy.data, np.memmap)
    tsolver = kp.KaMinPar(tctx, device="cpu").set_graph(lazy)
    tsolver.set_output_level(0)
    tpart = tsolver.compute_partition(k=4, epsilon=0.03, seed=1)
    np.testing.assert_array_equal(tpart, jpart)
    assert tsolver.last_gate["valid"] and tsolver.last_gate["cut_match"]
    assert (tsolver.last_external is not None) == (scheme == "external")
