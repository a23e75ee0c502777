"""The native host libraries: the multilevel 2-way bipartitioner (ip.cpp)
and the localized batch k-way FM (fm.cpp).

Both sources are this package's own byte-for-byte copies of the JAX
package's.  Each is compiled by ``g++`` at first use into ``_build/``
beside the CUDA kernels, with the flags the JAX package uses for them, so
that their floating-point stopping rules compile the same way; a
library's file name carries a hash of its source and the flags.  Nothing
is built when this module is imported, and a build that is attempted and
fails raises: no path falls back quietly to numpy.

The native paths are the defaults, as in the JAX package.
``KAMINPAR_TPU_NO_NATIVE_IP=1`` selects the numpy bipartitioner
(initial/), and so does a host without ``g++``;
``KAMINPAR_TPU_NO_NATIVE_FM=1`` selects the numpy FM (refinement/fm.py).
``ml_bipartition.calls`` and ``fm_refine.calls`` count the native calls of
this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++20", "-pthread")

# fm_refine's refusal sentinel, as in fm.cpp: the sparse engine's 16-bit
# block tags cannot hold k and the dense (n, k) table is unaffordable
FM_REFUSED = -(1 << 63)

_lib: Optional[ctypes.CDLL] = None
_fm_lib: Optional[ctypes.CDLL] = None
# guards the lazy loads and the call counters: the host extension calls
# ml_bipartition from worker threads
_lock = threading.Lock()

_I32, _I64, _F64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
_P_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_P_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def _build(source: Path) -> Path:
    out = _lib_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stderr}")
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
    return ret


fm_refine.calls = 0
