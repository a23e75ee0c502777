"""The native host libraries: the multilevel 2-way bipartitioner (ip.cpp),
the localized batch k-way FM (fm.cpp) and the neighborhood codecs of
compressed graphs (codec.cpp, the varint gap codec and the one-pass METIS
body tokenizer, and codec2.cpp, the "v2" codec: intervals,
StreamVByte-class residuals, varint weights).

Every source is this package's own byte-for-byte copy of the JAX
package's.  Each library is compiled by ``g++`` at first use into
``_build/`` beside the CUDA kernels, with the flags the JAX package uses
(the codecs add ``-mssse3`` on x86 for codec2's SIMD residual decode), so
that floating-point stopping rules compile the same way; a library's
file name carries a hash of its sources and the flags.  Nothing is built
when this module is imported, and a build that is attempted and fails
raises: no path falls back quietly to numpy.

The native paths are the defaults, as in the JAX package.
``KAMINPAR_TPU_NO_NATIVE_IP=1`` selects the numpy bipartitioner
(initial/), and so does a host without ``g++``;
``KAMINPAR_TPU_NO_NATIVE_FM=1`` selects the numpy FM (refinement/fm.py).
``ml_bipartition.calls``, ``fm_refine.calls`` and ``parse_metis_body.calls``
count the native calls of this process.  The gap codec has a numpy twin
(``encode_gaps_np``, ``decode_gaps_np``) that a host without ``g++``
takes; the v2 codec is native only, and ``codec="auto"`` means v2
whenever the codec library is built or buildable (``codec_enabled``).
The METIS tokenizer is used whenever the codec library is: without it
`io.metis` takes its Python parser, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..context import FMStoppingRule
from ..graphs.host import HostGraph

NO_NATIVE_IP_ENV = "KAMINPAR_TPU_NO_NATIVE_IP"
NO_NATIVE_FM_ENV = "KAMINPAR_TPU_NO_NATIVE_FM"
SOURCE = Path(__file__).resolve().with_name("ip.cpp")
FM_SOURCE = Path(__file__).resolve().with_name("fm.cpp")
CODEC_SOURCES = tuple(
    Path(__file__).resolve().with_name(f) for f in ("codec.cpp", "codec2.cpp")
)
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++20", "-pthread")
# codec2.cpp's SIMD residual decode is guarded by __SSSE3__ (scalar on
# other architectures), as in the JAX package's build
CODEC_FLAGS = GXX_FLAGS + (
    ("-mssse3",) if platform.machine() in ("x86_64", "AMD64", "i686") else ()
)

# fm_refine's refusal sentinel, as in fm.cpp: the sparse engine's 16-bit
# block tags cannot hold k and the dense (n, k) table is unaffordable
FM_REFUSED = -(1 << 63)

_lib: Optional[ctypes.CDLL] = None
_fm_lib: Optional[ctypes.CDLL] = None
_codec_lib: Optional[ctypes.CDLL] = None
# guards the lazy loads and the call counters: the host extension calls
# ml_bipartition from worker threads
_lock = threading.Lock()

_I32, _I64, _F64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
_P_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_P_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_P_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _lib_path(sources, flags=GXX_FLAGS) -> Path:
    sources = (sources,) if isinstance(sources, Path) else tuple(sources)
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in sources) + " ".join(flags).encode()
    ).hexdigest()
    return BUILD_DIR / f"{sources[0].stem}-{digest[:16]}.so"


def _build(sources, flags=GXX_FLAGS) -> Path:
    sources = (sources,) if isinstance(sources, Path) else tuple(sources)
    out = _lib_path(sources, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        ["g++", *flags, *(str(s) for s in sources), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        names = ", ".join(s.name for s in sources)
        raise RuntimeError(f"g++ failed for {names}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def enabled() -> bool:
    """Whether the initial bipartitioner takes the native path: not
    switched off by KAMINPAR_TPU_NO_NATIVE_IP=1, and built or buildable."""
    if os.environ.get(NO_NATIVE_IP_ENV, "") == "1":
        return False
    return _lib is not None or _lib_path(SOURCE).exists() or (
        shutil.which("g++") is not None
    )


def build() -> Path:
    """Compile ip.cpp unless a current build exists; returns the library's
    path.  Raises RuntimeError when g++ fails."""
    return _build(SOURCE)


def build_fm() -> Path:
    """Compile fm.cpp unless a current build exists; returns the library's
    path.  Raises RuntimeError when g++ fails."""
    return _build(FM_SOURCE)


def build_codec() -> Path:
    """Compile codec.cpp and codec2.cpp into one library unless a current
    build exists; returns its path.  Raises RuntimeError when g++ fails."""
    return _build(CODEC_SOURCES, CODEC_FLAGS)


def codec_enabled() -> bool:
    """Whether the codec library is built or buildable (a host with g++):
    then the gap codec runs natively and ``codec="auto"`` picks v2."""
    return _codec_lib is not None or _lib_path(
        CODEC_SOURCES, CODEC_FLAGS).exists() or (
        shutil.which("g++") is not None
    )


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kmp_ml_bipartition.restype = _I64
            lib.kmp_ml_bipartition.argtypes = [
                _I64, _P_I64, _P_I32, _P_I64, _P_I64, _I64, _I64,  # graph
                _I64, _F64, _I64,                                  # coarsening
                _I64, _I64, _I64, _F64, _I32, _I32, _I32, _I32,    # pool
                _I32, _I32, _I64, _F64, _I64,                      # pool FM
                _I32, _I32, _I64, _F64, _I64,                      # level FM
                ctypes.c_uint64,
                np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            ]
            _lib = lib
        return _lib


def _load_fm() -> ctypes.CDLL:
    global _fm_lib
    with _lock:
        if _fm_lib is None:
            lib = ctypes.CDLL(str(build_fm()))
            for fn in (lib.kmp_fm_refine, lib.kmp_fm_refine_sparse):
                fn.restype = _I64
                fn.argtypes = [
                    _I64, _P_I64, _P_I32, _P_I64, _P_I64, _I64, _P_I64,
                    np.ctypeslib.ndpointer(
                        np.int32, flags="C_CONTIGUOUS,WRITEABLE"),
                    _I64, _I64, _F64, _I64, _I32, ctypes.c_uint64, _I64,
                ]
            _fm_lib = lib
        return _fm_lib


def _load_codec() -> ctypes.CDLL:
    global _codec_lib
    with _lock:
        if _codec_lib is None:
            lib = ctypes.CDLL(str(build_codec()))
            for name, ret, args in (
                ("kmp_encode_gaps_size", _I64, [_I64, _P_I64, _P_I32, _P_I64]),
                ("kmp_encode_gaps", None,
                 [_I64, _P_I64, _P_I32, _P_I64, _P_U8]),
                ("kmp_decode_gaps", None,
                 [_I64, _P_I64, _P_I64, _P_U8, _P_I32]),
                ("kmp_decode_node", _I64,
                 [_I64, _P_I64, _P_I64, _P_U8, _P_I32]),
                ("kmp_encode_v2_size", _I64, [_I64, _P_I64, _P_I32, _P_I64]),
                ("kmp_encode_v2", None,
                 [_I64, _P_I64, _P_I32, _P_I64, _P_U8]),
                ("kmp_decode_v2", None,
                 [_I64, _P_I64, _P_I64, _P_U8, _P_I32]),
                ("kmp_decode_v2_node", _I64,
                 [_I64, _P_I64, _P_I64, _P_U8, _P_I32]),
                ("kmp_encode_v2_weights_size", _I64,
                 [_I64, _P_I64, _P_I32, _P_I64, _P_I64]),
                ("kmp_encode_v2_weights", None,
                 [_I64, _P_I64, _P_I32, _P_I64, _P_I64, _P_U8]),
                ("kmp_decode_v2_weights", None,
                 [_I64, _P_I64, _P_I64, _P_U8, _P_I64]),
                ("kmp_parse_metis_body", _I64,
                 [ctypes.c_char_p, _I64, _I64, ctypes.c_int, ctypes.c_int,
                  _I64, _P_I64, _P_I32, _P_I64, _P_I64]),
            ):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ret, args
            _codec_lib = lib
        return _codec_lib


def _count(fn) -> None:
    with _lock:
        fn.calls += 1


def _graph_arrays(graph: HostGraph):
    return (
        np.ascontiguousarray(graph.xadj, dtype=np.int64),
        np.ascontiguousarray(graph.adjncy, dtype=np.int32),
        np.ascontiguousarray(graph.node_weight_array(), dtype=np.int64),
        np.ascontiguousarray(graph.edge_weight_array(), dtype=np.int64),
    )


def ml_bipartition(graph: HostGraph, max_block_weights, ip_ctx,
                   seed: int) -> np.ndarray:
    """Native multilevel bipartition of a non-empty HostGraph; returns an
    int8 partition.  The arguments are filled as the JAX package's
    native.ml_bipartition fills them."""
    lib = _load()
    xadj, adjncy, node_w, edge_w = _graph_arrays(graph)
    max_bw = np.asarray(max_block_weights, dtype=np.int64)
    ic = ip_ctx.coarsening
    pool = ip_ctx.pool
    pfm = pool.refinement
    fm = ip_ctx.refinement
    max_cluster_weight = max(
        1, int(ic.cluster_weight_multiplier * int(max_bw.max()))
    )
    out = np.empty(graph.n, dtype=np.int8)
    lib.kmp_ml_bipartition(
        graph.n, xadj, adjncy, node_w, edge_w,
        int(max_bw[0]), int(max_bw[1]),
        int(ic.contraction_limit), float(ic.convergence_threshold),
        max_cluster_weight,
        int(pool.min_num_repetitions),
        int(pool.min_num_non_adaptive_repetitions),
        int(pool.max_num_repetitions), float(pool.repetition_multiplier),
        int(bool(pool.use_adaptive_bipartitioner_selection)),
        int(bool(pool.enable_bfs_bipartitioner)),
        int(bool(pool.enable_ggg_bipartitioner)),
        int(bool(pool.enable_random_bipartitioner)),
        int(bool(pfm.disabled)),
        int(pfm.stopping_rule == FMStoppingRule.ADAPTIVE),
        int(pfm.num_fruitless_moves), float(pfm.alpha),
        int(pfm.num_iterations),
        int(bool(fm.disabled)),
        int(fm.stopping_rule == FMStoppingRule.ADAPTIVE),
        int(fm.num_fruitless_moves), float(fm.alpha),
        int(fm.num_iterations),
        int(seed) & 0xFFFFFFFFFFFFFFFF, out,
    )
    _count(ml_bipartition)
    return out


ml_bipartition.calls = 0


def fm_refine(graph: HostGraph, partition: np.ndarray, k: int,
              max_block_weights, fm_ctx, seed: int, threads: int = 1,
              force_sparse: bool = False) -> int:
    """Native localized batch FM on a HostGraph partition: refines the
    int32 `partition` in place and returns the total cut improvement, or
    FM_REFUSED when the native side refused to run.  The arguments are
    filled as the JAX package's native.fm_refine fills them; `threads` > 1
    runs fm.cpp's worker pool (1 is deterministic), `force_sparse` takes
    the sparse gain-table path at any k.  A graph without nodes or k <= 1
    has nothing to refine and returns 0 without a call."""
    if partition.dtype != np.int32 or not partition.flags.c_contiguous:
        raise ValueError("partition must be a contiguous int32 array")
    if graph.n == 0 or k <= 1:
        return 0
    lib = _load_fm()
    xadj, adjncy, node_w, edge_w = _graph_arrays(graph)
    max_bw = np.ascontiguousarray(max_block_weights, dtype=np.int64)
    fn = lib.kmp_fm_refine_sparse if force_sparse else lib.kmp_fm_refine
    ret = int(fn(
        graph.n, xadj, adjncy, node_w, edge_w, int(k), max_bw, partition,
        int(fm_ctx.num_iterations), int(fm_ctx.num_seed_nodes),
        float(fm_ctx.alpha), int(fm_ctx.num_fruitless_moves),
        1,  # adaptive stopping (the reference's default for FM)
        int(seed) & 0xFFFFFFFFFFFFFFFF,
        max(1, int(threads)),
    ))
    _count(fm_refine)
    if ret == FM_REFUSED:
        from .. import telemetry
        from ..utils.logger import log_warning

        # only the sparse engine refuses (16-bit packed tags)
        reason = "k exceeds the sparse engine's 16-bit tag limit (0xFFFF)"
        reason += (
            " (sparse path forced)" if force_sparse
            else " and the dense (n, k) table is unaffordable"
        )
        telemetry.event("fm-refused", n=int(graph.n), k=int(k), reason=reason)
        log_warning(f"native FM did not run: {reason} (n={graph.n}, k={k})")
    return ret


fm_refine.calls = 0


# --------------------------------------------------------------------------
# neighborhood codecs (codec.cpp, codec2.cpp)
# --------------------------------------------------------------------------


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def encode_gaps(xadj, adjncy):
    """Encode sorted CSR neighborhoods as varint gap streams; returns
    (bytes u8[total], offsets i64[n+1]).  Native when the codec library
    is built or buildable, else the numpy twin (the same bytes)."""
    n = len(xadj) - 1
    xadj, adjncy = _i64(xadj), _i32(adjncy)
    if not codec_enabled():
        return encode_gaps_np(xadj, adjncy)
    lib = _load_codec()
    offsets = np.zeros(n + 1, dtype=np.int64)
    out = np.empty(lib.kmp_encode_gaps_size(n, xadj, adjncy, offsets),
                   dtype=np.uint8)
    lib.kmp_encode_gaps(n, xadj, adjncy, offsets, out)
    return out, offsets


def decode_gaps(xadj, offsets, data) -> np.ndarray:
    """Inverse of encode_gaps; returns adjncy i32[m]."""
    n = len(xadj) - 1
    xadj, offsets, data = _i64(xadj), _i64(offsets), _u8(data)
    out = np.empty(int(xadj[-1]), dtype=np.int32)
    if not codec_enabled():
        return decode_gaps_np(xadj, offsets, data, out)
    _load_codec().kmp_decode_gaps(n, xadj, offsets, data, out)
    return out


def decode_node(u: int, xadj, offsets, data) -> np.ndarray:
    """One node's neighborhood from a gap stream."""
    deg = int(xadj[u + 1] - xadj[u])
    out = np.empty(deg, dtype=np.int32)
    if deg == 0:
        return out
    if not codec_enabled():
        piece = _u8(data[int(offsets[u]): int(offsets[u + 1])])
        return decode_gaps_np(np.array([0, deg], dtype=np.int64),
                              np.zeros(2, dtype=np.int64), piece, out)
    _load_codec().kmp_decode_node(int(u), _i64(xadj), _i64(offsets),
                                  _u8(data), out)
    return out


def _varint_sizes_np(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint64)
    sizes = np.ones(len(vals), dtype=np.int64)
    for k in range(1, 5):
        sizes += (v >= (1 << (7 * k))).astype(np.int64)
    return sizes


def encode_gaps_np(xadj, adjncy):
    """The numpy twin of encode_gaps (byte-identical)."""
    xadj, adjncy = _i64(xadj), _i32(adjncy)
    m = int(xadj[-1])
    first_mask = np.zeros(m, dtype=bool)
    nonempty = xadj[1:] > xadj[:-1]
    first_mask[xadj[:-1][nonempty]] = True
    gaps = np.empty(m, dtype=np.uint32)
    if m:
        gaps[1:] = np.diff(adjncy.astype(np.int64)).astype(np.uint32)
        gaps[first_mask] = adjncy[first_mask].astype(np.uint32) + 1
    sizes = _varint_sizes_np(gaps) if m else np.zeros(0, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(sizes)])
    offsets = csum[xadj]
    out = np.zeros(int(csum[-1]), dtype=np.uint8)
    # byte-by-byte scatter, vectorized over the byte position
    pos = csum[:-1].copy() if m else csum[:0]
    rem = gaps.copy()
    active = np.ones(m, dtype=bool)
    while m and active.any():
        idx = np.nonzero(active)[0]
        b = (rem[idx] & 0x7F).astype(np.uint8)
        more = rem[idx] >= 0x80
        out[pos[idx]] = b | (more.astype(np.uint8) << 7)
        pos[idx] += 1
        rem[idx] >>= 7
        active[idx] = more
    return out, offsets


def decode_gaps_np(xadj, offsets, data, out=None) -> np.ndarray:
    """The numpy twin of decode_gaps (sequential)."""
    n = len(xadj) - 1
    if out is None:
        out = np.empty(int(xadj[-1]), dtype=np.int32)
    for u in range(n):
        p = int(offsets[u])
        lo, hi = int(xadj[u]), int(xadj[u + 1])
        prev = -1
        for e in range(lo, hi):
            x = 0
            shift = 0
            while True:
                byte = int(data[p])
                p += 1
                x |= (byte & 0x7F) << shift
                if not byte & 0x80:
                    break
                shift += 7
            prev = x - 1 if e == lo else prev + x
            out[e] = prev
    return out


def parse_metis_body(body: bytes, n: int, has_vw: bool, has_ew: bool,
                     m2: int, xadj, adjncy, vw, ew) -> int:
    """The one-pass METIS body tokenizer (codec.cpp): fills the given
    arrays and returns the number of directed edges, or -(node + 1) for
    the first malformed node line."""
    ret = int(_load_codec().kmp_parse_metis_body(
        body, len(body), int(n), int(has_vw), int(has_ew), int(m2),
        xadj, adjncy, vw, ew,
    ))
    _count(parse_metis_body)
    return ret


parse_metis_body.calls = 0


def encode_v2(xadj, adjncy):
    """Encode sorted CSR neighborhoods with the v2 codec; returns
    (bytes u8[total], offsets i64[n+1])."""
    lib = _load_codec()
    n = len(xadj) - 1
    xadj, adjncy = _i64(xadj), _i32(adjncy)
    offsets = np.zeros(n + 1, dtype=np.int64)
    out = np.empty(lib.kmp_encode_v2_size(n, xadj, adjncy, offsets),
                   dtype=np.uint8)
    lib.kmp_encode_v2(n, xadj, adjncy, offsets, out)
    return out, offsets


def decode_v2(xadj, offsets, data) -> np.ndarray:
    """Decode a v2 stream; returns adjncy i32[m] in emit order (interval
    members first, so it pairs 1:1 with the weight stream)."""
    lib = _load_codec()
    xadj = _i64(xadj)
    out = np.empty(int(xadj[-1]), dtype=np.int32)
    lib.kmp_decode_v2(len(xadj) - 1, xadj, _i64(offsets), _u8(data), out)
    return out


def decode_v2_node(u: int, xadj, offsets, data) -> np.ndarray:
    """One node's neighborhood from a v2 stream, in emit order."""
    deg = int(xadj[u + 1] - xadj[u])
    out = np.empty(deg, dtype=np.int32)
    if deg:
        _load_codec().kmp_decode_v2_node(int(u), _i64(xadj), _i64(offsets),
                                         _u8(data), out)
    return out


def encode_v2_weights(xadj, adjncy, edge_w):
    """Varint-encode edge weights in the v2 emit order; returns (bytes,
    woffsets i64[n+1])."""
    lib = _load_codec()
    n = len(xadj) - 1
    xadj, adjncy, edge_w = _i64(xadj), _i32(adjncy), _i64(edge_w)
    woffsets = np.zeros(n + 1, dtype=np.int64)
    out = np.empty(
        lib.kmp_encode_v2_weights_size(n, xadj, adjncy, edge_w, woffsets),
        dtype=np.uint8,
    )
    lib.kmp_encode_v2_weights(n, xadj, adjncy, edge_w, woffsets, out)
    return out, woffsets


def decode_v2_weights(xadj, woffsets, wdata) -> np.ndarray:
    """Inverse of encode_v2_weights; returns i64[m] in emit order."""
    lib = _load_codec()
    xadj = _i64(xadj)
    out = np.empty(int(xadj[-1]), dtype=np.int64)
    lib.kmp_decode_v2_weights(len(xadj) - 1, xadj, _i64(woffsets),
                              _u8(wdata), out)
    return out
