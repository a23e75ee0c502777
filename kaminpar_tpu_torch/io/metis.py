"""METIS text graph format reader/writer (counterpart of
kaminpar_tpu/io/metis.py; kaminpar-io/metis_parser.cc, format per
docs/graph_file_format.md):
header `n m [fmt]` where fmt ∈ {00, 10, 01, 11} flags node/edge weights;
one line per node, 1-based neighbor ids, optional leading node weight and
per-neighbor edge weight.  Comment lines start with '%'.

The reference uses an mmap-based char tokenizer (kaminpar-io/util/
file_toker.h); `load_metis` takes its analog, the one-pass native
tokenizer of native/codec.cpp, whenever the codec library is built or
buildable (a failed build raises), and the Python parser otherwise or when
the header cannot be split off.  Error messages and line numbers are the
JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..graphs.host import HostGraph
from .errors import GraphFormatError


def parse_metis(text: str) -> HostGraph:
    # keep empty lines: a node with no neighbors is an empty line.
    # Original 1-based line numbers ride along so every violation can
    # name its line (GraphFormatError contract).
    lines = [
        (i + 1, l.strip())
        for i, l in enumerate(text.splitlines())
        if not l.lstrip().startswith("%")
    ]
    while lines and not lines[0][1]:
        lines.pop(0)
    if not lines:
        raise GraphFormatError("empty METIS file", line=1)

    header_ln, header_text = lines[0]
    header = header_text.split()
    if len(header) < 2:
        raise GraphFormatError(
            "header must be 'n m [fmt]'", line=header_ln
        )
    try:
        n = int(header[0])
        m_undirected = int(header[1])
    except ValueError:
        raise GraphFormatError(
            f"non-integer header token in {header_text!r}", line=header_ln
        ) from None
    if n < 0 or m_undirected < 0:
        raise GraphFormatError("negative n or m in header", line=header_ln)
    m2 = m_undirected * 2  # file stores undirected edge count
    # a corrupted header cannot commandeer an astronomic allocation:
    # every directed edge needs at least two characters of body
    if m2 > 2 * max(len(text), 1):
        raise GraphFormatError(
            f"header claims {m2} directed edges but the file is only "
            f"{len(text)} bytes",
            line=header_ln,
        )
    fmt = header[2] if len(header) > 2 else "0"
    has_node_weights = len(fmt) >= 2 and fmt[-2] == "1"
    has_edge_weights = fmt[-1] == "1"

    if len(lines) - 1 < n:
        raise GraphFormatError(
            f"expected {n} node lines, found {len(lines) - 1} "
            "(truncated file?)",
            line=lines[-1][0],
        )

    # token-stream fast path: per node line, tokens are
    # [vw] (v [ew]) (v [ew]) ...
    per_line_tokens = []
    for ln, l in lines[1 : n + 1]:
        try:
            per_line_tokens.append(np.array(l.split(), dtype=np.int64))
        except OverflowError:
            raise GraphFormatError(
                "weight or id overflows 64-bit", line=ln
            ) from None
        except ValueError:
            raise GraphFormatError("non-integer token", line=ln) from None
    line_numbers = [ln for ln, _ in lines[1 : n + 1]]
    degrees = np.zeros(n, dtype=np.int64)
    stride = 2 if has_edge_weights else 1
    for i, toks in enumerate(per_line_tokens):
        cnt = len(toks) - (1 if has_node_weights else 0)
        if cnt < 0 or cnt % stride:
            raise GraphFormatError(
                "malformed adjacency (token count does not match the "
                "header's weight flags)",
                line=line_numbers[i],
            )
        degrees[i] = cnt // stride

    xadj = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=xadj[1:])
    m = int(xadj[-1])
    if m != m2:
        # tolerated like the reference tolerates trailing data, but warn-level
        # strictness: mismatch is almost always a broken file
        raise GraphFormatError(
            f"header claims {m2} directed edges, file has {m}",
            line=header_ln,
        )

    adjncy = np.empty(m, dtype=np.int32)
    edge_weights = np.empty(m, dtype=np.int64) if has_edge_weights else None
    node_weights = np.empty(n, dtype=np.int64) if has_node_weights else None

    for i, toks in enumerate(per_line_tokens):
        off = 0
        if has_node_weights:
            if toks[0] < 0:
                raise GraphFormatError(
                    f"negative node weight {int(toks[0])}",
                    line=line_numbers[i],
                )
            node_weights[i] = toks[0]
            off = 1
        body = toks[off:]
        s, e = xadj[i], xadj[i + 1]
        if has_edge_weights:
            adjncy[s:e] = body[0::2] - 1
            edge_weights[s:e] = body[1::2]
        else:
            adjncy[s:e] = body - 1

    if m and (adjncy.min() < 0 or adjncy.max() >= n):
        bad = int(
            np.flatnonzero((adjncy < 0) | (adjncy >= n))[0]
        )
        node = int(np.searchsorted(xadj, bad, side="right")) - 1
        raise GraphFormatError(
            f"neighbor id {int(adjncy[bad]) + 1} out of range [1, {n}]",
            line=line_numbers[node],
        )
    if edge_weights is not None and m and edge_weights.min() < 0:
        bad = int(np.flatnonzero(edge_weights < 0)[0])
        node = int(np.searchsorted(xadj, bad, side="right")) - 1
        raise GraphFormatError(
            "negative edge weight", line=line_numbers[node]
        )
    return HostGraph(
        xadj=xadj,
        adjncy=adjncy,
        node_weights=node_weights,
        edge_weights=edge_weights,
    )


def load_metis(path: str) -> HostGraph:
    with open(path, "rb") as f:
        raw = f.read()
    try:
        graph = _parse_metis_native(raw)
        if graph is not None:
            return graph
        return parse_metis(raw.decode("latin-1"))
    except GraphFormatError as e:
        raise e.with_path(path) from None


def _parse_metis_native(raw: bytes) -> HostGraph | None:
    """One-pass native tokenizer (the file_toker.h analog, native/codec.cpp
    kmp_parse_metis_body); None -> the Python parser (no g++ on this host,
    or no header line)."""
    from .. import native

    if not native.codec_enabled():
        return None
    # split off the header line (skipping leading comments)
    pos = 0
    header = None
    while pos < len(raw):
        eol = raw.find(b"\n", pos)
        if eol < 0:
            eol = len(raw)
        line = raw[pos:eol].strip()
        pos = eol + 1
        if line and not line.startswith(b"%"):
            header = line.split()
            break
    if header is None or len(header) < 2:
        return None
    try:
        n = int(header[0])
        m2 = int(header[1]) * 2
    except ValueError:
        raise GraphFormatError(
            "non-integer header token", line=1
        ) from None
    if n < 0 or m2 < 0:
        raise GraphFormatError("negative n or m in header", line=1)
    if m2 > 2 * max(len(raw), 1):
        raise GraphFormatError(
            f"header claims {m2} directed edges but the file is only "
            f"{len(raw)} bytes",
            line=1,
        )
    fmt = header[2].decode() if len(header) > 2 else "0"
    has_vw = len(fmt) >= 2 and fmt[-2] == "1"
    has_ew = fmt[-1] == "1"

    body = raw[pos:]
    xadj = np.zeros(n + 1, dtype=np.int64)
    adjncy = np.zeros(max(m2, 1), dtype=np.int32)
    vw = np.zeros(n if has_vw else 1, dtype=np.int64)
    ew = np.zeros(max(m2, 1) if has_ew else 1, dtype=np.int64)
    m = native.parse_metis_body(
        body, n, has_vw, has_ew, m2, xadj, adjncy, vw, ew,
    )
    if m < 0:
        # -m is the 1-based NODE index whose line is malformed; the
        # native tokenizer does not track comment lines, so report the
        # node index rather than a possibly-off-by-comments line number
        raise GraphFormatError(
            f"malformed adjacency on node {-m} (line {-m} + header/"
            "comment lines)"
        )
    if m != m2:
        raise GraphFormatError(
            f"header claims {m2} directed edges, file has {m}", line=1
        )
    if m and (adjncy[:m].min() < 0 or adjncy[:m].max() >= n):
        raise GraphFormatError("neighbor id out of range")
    if has_vw and n and vw.min() < 0:
        raise GraphFormatError("negative node weight")
    if has_ew and m and ew[:m].min() < 0:
        raise GraphFormatError("negative edge weight")
    return HostGraph(
        xadj=xadj,
        adjncy=adjncy[:m],
        node_weights=vw if has_vw else None,
        edge_weights=ew[:m] if has_ew else None,
    )


def write_metis(graph: HostGraph, path: str) -> None:
    n, m = graph.n, graph.m
    has_nw = graph.node_weights is not None
    has_ew = graph.edge_weights is not None
    fmt = f"{int(has_nw)}{int(has_ew)}"
    with open(path, "w") as f:
        header = f"{n} {m // 2}"
        if has_nw or has_ew:
            header += f" {fmt}"
        f.write(header + "\n")
        nw = graph.node_weights
        ew = graph.edge_weights
        if not has_nw and not has_ew and m > 0:
            # vectorized fast path: one token stream with '\n' as the
            # separator after each row's last edge, then blank lines
            # spliced back in for isolated nodes (which METIS encodes as
            # empty lines — see tests/test_io.py)
            deg = graph.degrees()
            tokens = np.char.mod("%d", graph.adjncy.astype(np.int64) + 1)
            sep = np.full(m, " ", dtype="U1")
            row_ends = np.asarray(graph.xadj[1:], dtype=np.int64)[deg > 0] - 1
            sep[row_ends] = "\n"
            body = "".join(np.char.add(tokens, sep))
            lines = body.split("\n")[:-1]  # one entry per nonempty row
            it = iter(lines)
            f.write("\n".join(next(it) if d else "" for d in deg > 0) + "\n")
        else:
            for u in range(n):
                parts = []
                if has_nw:
                    parts.append(str(int(nw[u])))
                for e in range(int(graph.xadj[u]), int(graph.xadj[u + 1])):
                    parts.append(str(int(graph.adjncy[e]) + 1))
                    if has_ew:
                        parts.append(str(int(ew[e])))
                f.write(" ".join(parts) + "\n")
