"""Graph and partition IO (counterpart of kaminpar_tpu/io; kaminpar-io):
METIS and ParHiP files, the compressed-graph container, partition files,
and the KaGen-style generator specs (io/skagen.py)."""

from __future__ import annotations

import os

from .errors import GraphFormatError  # noqa: F401
from .metis import load_metis, parse_metis, write_metis  # noqa: F401
from .parhip import load_parhip, parse_parhip, write_parhip  # noqa: F401
from .compressed_binary import (  # noqa: F401
    is_compressed_file,
    load_compressed,
    write_compressed,
)
from .partition import (  # noqa: F401
    read_partition,
    write_partition,
    read_block_sizes,
    write_block_sizes,
    write_remapping,
)


def load_graph(path: str, fmt: str = "auto", ordering: str = "natural",
               lazy: bool = False):
    """Load a graph by file format (kaminpar_io.h read_graph analog).
    fmt: 'metis', 'parhip', 'compressed', or 'auto' (sniff by extension
    then content).  'compressed' returns a CompressedHostGraph.
    ordering: 'natural' keeps file order; 'degree-buckets' rearranges
    nodes into exponentially-spaced degree buckets (not applicable to
    compressed containers).  ``lazy`` memory-maps a ZIP_STORED compressed
    container member by member (the external scheme's disk tier) instead
    of reading it whole."""
    if ordering not in ("natural", "degree-buckets"):
        raise ValueError(f"unknown node ordering: {ordering}")
    if fmt == "auto":
        ext = os.path.splitext(path)[1].lower()
        if ext in (".metis", ".graph", ".txt"):
            fmt = "metis"
        elif ext in (".parhip", ".bgf", ".bin"):
            fmt = "parhip"
        elif ext == ".npz" or is_compressed_file(path):
            fmt = "compressed"
        else:
            with open(path, "rb") as f:
                head = f.read(64)
            fmt = "metis" if _looks_like_text(head) else "parhip"
    if fmt == "compressed" and ordering != "natural":
        raise ValueError("ordering is not supported for compressed containers")
    if fmt == "metis":
        graph = load_metis(path)
    elif fmt == "parhip":
        graph = load_parhip(path)
    elif fmt == "compressed":
        return load_compressed(path, lazy=lazy)
    else:
        raise ValueError(f"unknown graph format: {fmt}")
    if ordering == "degree-buckets":
        from ..graphs.host import apply_permutation, degree_bucket_permutation

        graph = apply_permutation(graph, degree_bucket_permutation(graph))
    return graph


def _looks_like_text(head: bytes) -> bool:
    try:
        head.decode("ascii")
        return True
    except UnicodeDecodeError:
        return False
