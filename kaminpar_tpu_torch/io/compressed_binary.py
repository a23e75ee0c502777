"""On-disk compressed graph format (counterpart of
kaminpar_tpu/io/compressed_binary.py; graph_compression_binary.cc).

Stores the encoded streams of a CompressedHostGraph plus weights in a
single .npz container with a magic key, so compressed graphs load without
re-encoding (the reference's `--input-format compressed` path).  The
container, its magic and its members are the JAX package's: a file
written by either package loads in the other.

Two load paths:

  * **eager** (the default): every member materializes into host RAM up
    front — fine for graphs the host holds comfortably;
  * **lazy/mmap** (``load_compressed(path, lazy=True)``, used by the
    out-of-core `external` scheme): ZIP_STORED members are
    ``np.memmap``-ed at their byte offset inside the container, so
    ``decode_range`` touches only the pages a chunk needs and a
    disk-backed fine graph streams WITHOUT the full-file RAM spike the
    eager path pays.  Containers written with ``compress=False`` are
    fully mmapable; deflated members (``np.savez_compressed``) cannot be
    randomly accessed and fall back to an eager read per member.
"""

from __future__ import annotations

import zipfile

import numpy as np

from ..graphs.compressed import CompressedHostGraph

MAGIC = "kaminpar-tpu-compressed-v1"

_MEMBERS = ("xadj", "offsets", "data", "node_weights", "edge_weights",
            "wdata", "woffsets")


def write_compressed(path: str, graph: CompressedHostGraph,
                     compress: bool = True) -> None:
    """Write the container.  ``compress=False`` stores members raw
    (ZIP_STORED) so ``load_compressed(..., lazy=True)`` can mmap them —
    the on-disk tier of the external scheme trades the codec's own
    compression (the byte streams are already varint-packed) for
    chunk-granular random access."""
    arrays = {
        "magic": np.frombuffer(MAGIC.encode(), dtype=np.uint8),
        "xadj": graph.xadj,
        "offsets": graph.offsets,
        "data": graph.data,
        "codec": np.frombuffer(graph.codec.encode(), dtype=np.uint8),
    }
    if graph.node_weights is not None:
        arrays["node_weights"] = np.asarray(graph.node_weights)
    if graph.edge_weights is not None:
        arrays["edge_weights"] = np.asarray(graph.edge_weights)
    if graph.wdata is not None:
        arrays["wdata"] = graph.wdata
        arrays["woffsets"] = graph.woffsets
    (np.savez_compressed if compress else np.savez)(path, **arrays)


def _mmap_npy_member(path: str, info: "zipfile.ZipInfo"):
    """np.memmap one ZIP_STORED .npy member at its in-container byte
    offset (None when the member cannot be mapped: deflated, fortran,
    object dtype, or an unknown npy version)."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        lh = f.read(30)
        if len(lh) < 30 or lh[:4] != b"PK\x03\x04":
            return None
        name_len = int.from_bytes(lh[26:28], "little")
        extra_len = int.from_bytes(lh[28:30], "little")
        f.seek(info.header_offset + 30 + name_len + extra_len)
        try:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = (
                    np.lib.format.read_array_header_1_0(f)
                )
            elif version == (2, 0):
                shape, fortran, dtype = (
                    np.lib.format.read_array_header_2_0(f)
                )
            else:
                return None
        except ValueError:
            return None
        if fortran or dtype.hasobject:
            return None
        offset = f.tell()
    if int(np.prod(shape, dtype=np.int64)) == 0:
        return np.zeros(shape, dtype=dtype)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=shape)


def _lazy_members(path: str) -> dict:
    """name -> mmapped array for every mappable member."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            key = info.filename[:-4]
            if key not in _MEMBERS:
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                continue
            arr = _mmap_npy_member(path, info)
            if arr is not None:
                out[key] = arr
    return out


def load_compressed(path: str, lazy: bool = False) -> CompressedHostGraph:
    """Load a container.  ``lazy=True`` memory-maps every ZIP_STORED
    member (chunk-granular page-in via decode_range) and eager-loads
    only what cannot be mapped; the default materializes everything up
    front (the historical behavior)."""
    lazy_map = _lazy_members(path) if lazy else {}
    with np.load(path) as z:
        if "magic" not in z or bytes(z["magic"]).decode() != MAGIC:
            raise ValueError(f"{path} is not a kaminpar-tpu compressed graph")

        def get(name):
            if name in lazy_map:
                return lazy_map[name]
            return z[name] if name in z else None

        return CompressedHostGraph(
            xadj=get("xadj"),
            offsets=get("offsets"),
            data=get("data"),
            node_weights=get("node_weights"),
            edge_weights=get("edge_weights"),
            codec=bytes(z["codec"]).decode() if "codec" in z else "gap",
            wdata=get("wdata"),
            woffsets=get("woffsets"),
        )


def is_compressed_file(path: str) -> bool:
    try:
        with np.load(path) as z:
            return "magic" in z and bytes(z["magic"]).decode() == MAGIC
    except (OSError, ValueError, zipfile.BadZipFile):
        return False
