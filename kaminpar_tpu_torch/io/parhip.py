"""ParHiP binary graph format reader/writer (counterpart of
kaminpar_tpu/io/parhip.py; kaminpar-io/parhip_parser.cc).  Layout per
docs/graph_file_format.md: a 24-byte header of three uint64 (version
bitfield, n, m), then byte offsets ([n+1] * EID bytes, relative to file
start), adjacency (m * NID), optional node weights (n * NWGT), optional
edge weights (m * EWGT).

Version bitfield (LSB first):
  bit 0: edge weights ABSENT (1 = unweighted)
  bit 1: node weights ABSENT
  bit 2: edge ids 32-bit (1) / 64-bit (0)
  bit 3: node ids 32-bit (1) / 64-bit (0)
  bit 4: node weights 32-bit (1)
  bit 5: edge weights 32-bit (1)
"""

from __future__ import annotations

import numpy as np

from ..graphs.host import HostGraph
from .errors import GraphFormatError

_HEADER_BYTES = 24


def load_parhip(path: str) -> HostGraph:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return parse_parhip(data)
    except GraphFormatError as e:
        raise e.with_path(path) from None


def _take(data: bytes, dtype, count: int, pos: int, what: str) -> np.ndarray:
    """frombuffer with an explicit truncation error naming the section
    and the byte offset where the file ran out."""
    need = pos + count * np.dtype(dtype).itemsize
    if len(data) < need:
        raise GraphFormatError(
            f"truncated ParHiP file: {what} needs bytes [{pos}, {need}), "
            f"file has {len(data)}",
            offset=len(data),
        )
    return np.frombuffer(data, dtype=dtype, count=count, offset=pos)


def parse_parhip(data: bytes) -> HostGraph:
    if len(data) < _HEADER_BYTES:
        raise GraphFormatError(
            "truncated ParHiP file: missing 24-byte header",
            offset=len(data),
        )
    version, n, m = np.frombuffer(data[:_HEADER_BYTES], dtype=np.uint64)
    version = int(version)
    n, m = int(n), int(m)

    has_edge_weights = not (version & 1)
    has_node_weights = not (version >> 1 & 1)
    eid_t = np.uint32 if version >> 2 & 1 else np.uint64
    nid_t = np.uint32 if version >> 3 & 1 else np.uint64
    nw_t = np.int32 if version >> 4 & 1 else np.int64
    ew_t = np.int32 if version >> 5 & 1 else np.int64

    pos = _HEADER_BYTES
    offsets = _take(data, eid_t, n + 1, pos, f"offset array (n={n})")
    pos += (n + 1) * np.dtype(eid_t).itemsize
    # offsets are byte addresses of first neighbor; normalize to edge
    # indices.  int64 view: corrupted huge uint64 values wrap and are
    # caught by the monotonicity / alignment / total checks below.
    nid_size = np.dtype(nid_t).itemsize
    o64 = offsets.astype(np.int64)
    if n and (np.diff(o64) < 0).any():
        bad = int(np.flatnonzero(np.diff(o64) < 0)[0])
        raise GraphFormatError(
            f"non-monotone neighborhood offsets at node {bad}",
            offset=_HEADER_BYTES + bad * np.dtype(eid_t).itemsize,
        )
    rel = o64 - int(o64[0])
    if (rel % nid_size != 0).any():
        raise GraphFormatError(
            f"offsets not aligned to the {nid_size}-byte neighbor id size",
            offset=_HEADER_BYTES,
        )
    xadj = rel // nid_size
    if xadj[-1] != m:
        raise GraphFormatError(
            f"offsets end at edge {int(xadj[-1])} but header claims m={m}",
            offset=_HEADER_BYTES,
        )

    adj_raw = _take(data, nid_t, m, pos, f"adjacency (m={m})")
    if m and int(adj_raw.max()) >= n:
        bad = int(np.flatnonzero(adj_raw >= np.uint64(n))[0])
        raise GraphFormatError(
            f"neighbor id {int(adj_raw[bad])} out of range [0, {n})",
            offset=pos + bad * nid_size,
        )
    adjncy = adj_raw.astype(np.int32)
    pos += m * nid_size

    node_weights = None
    if has_node_weights:
        node_weights = _take(
            data, nw_t, n, pos, f"node weights (n={n})"
        ).astype(np.int64)
        if n and node_weights.min() < 0:
            bad = int(np.flatnonzero(node_weights < 0)[0])
            raise GraphFormatError(
                f"negative node weight at node {bad}",
                offset=pos + bad * np.dtype(nw_t).itemsize,
            )
        pos += n * np.dtype(nw_t).itemsize

    edge_weights = None
    if has_edge_weights:
        edge_weights = _take(
            data, ew_t, m, pos, f"edge weights (m={m})"
        ).astype(np.int64)
        if m and edge_weights.min() < 0:
            bad = int(np.flatnonzero(edge_weights < 0)[0])
            raise GraphFormatError(
                f"negative edge weight at edge {bad}",
                offset=pos + bad * np.dtype(ew_t).itemsize,
            )

    return HostGraph(
        xadj=xadj,
        adjncy=adjncy,
        node_weights=node_weights,
        edge_weights=edge_weights,
    )


def write_parhip(graph: HostGraph, path: str, use_32bit: bool = True) -> None:
    n, m = graph.n, graph.m
    has_nw = graph.node_weights is not None
    has_ew = graph.edge_weights is not None
    version = 0
    if not has_ew:
        version |= 1
    if not has_nw:
        version |= 2
    eid_t = np.uint32 if use_32bit else np.uint64
    nid_t = np.uint32 if use_32bit else np.uint64
    if use_32bit:
        version |= 4 | 8 | 16 | 32
    nw_t = np.int32 if use_32bit else np.int64
    ew_t = np.int32 if use_32bit else np.int64

    nid_size = np.dtype(nid_t).itemsize
    base = _HEADER_BYTES + (n + 1) * np.dtype(eid_t).itemsize
    offsets = (graph.xadj.astype(np.int64) * nid_size + base).astype(eid_t)
    with open(path, "wb") as f:
        f.write(np.array([version, n, m], dtype=np.uint64).tobytes())
        f.write(offsets.tobytes())
        f.write(graph.adjncy.astype(nid_t).tobytes())
        if has_nw:
            f.write(graph.node_weights.astype(nw_t).tobytes())
        if has_ew:
            f.write(graph.edge_weights.astype(ew_t).tobytes())
