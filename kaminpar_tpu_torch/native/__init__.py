"""The native multilevel 2-way bipartitioner (ip.cpp), on the host.

ip.cpp is this package's own copy of the JAX package's native initial
bipartitioner: LP coarsening, the flat bipartitioner pool and 2-way FM at
every level, behind one C entry point, ``kmp_ml_bipartition``.  It is
compiled by ``g++`` at first use into ``_build/`` beside the CUDA kernels,
with the flags the JAX package uses for it, so that its floating-point
stopping rules compile the same way; the library's file name carries a
hash of source and flags.  Nothing is built when this module is imported.

The native path is the default, as in the JAX package.
``KAMINPAR_TPU_NO_NATIVE_IP=1`` selects the numpy path (initial/), and so
does a host without ``g++``; a build that is attempted and fails raises.
``ml_bipartition.calls`` counts the native bipartitions of this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..context import FMStoppingRule
from ..graphs.host import HostGraph

NO_NATIVE_IP_ENV = "KAMINPAR_TPU_NO_NATIVE_IP"
SOURCE = Path(__file__).resolve().with_name("ip.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++20", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"ip-{digest[:16]}.so"


def enabled() -> bool:
    """Whether the initial bipartitioner takes the native path: not
    switched off by KAMINPAR_TPU_NO_NATIVE_IP=1, and built or buildable."""
    if os.environ.get(NO_NATIVE_IP_ENV, "") == "1":
        return False
    return _lib is not None or _lib_path().exists() or (
        shutil.which("g++") is not None
    )


def build() -> Path:
    """Compile ip.cpp unless a current build exists; returns the library's
    path.  Raises RuntimeError when g++ fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.kmp_ml_bipartition.restype = i64
        lib.kmp_ml_bipartition.argtypes = [
            i64, p_i64, p_i32, p_i64, p_i64, i64, i64,       # graph + caps
            i64, f64, i64,                                   # coarsening
            i64, i64, i64, f64, i32, i32, i32, i32,          # pool
            i32, i32, i64, f64, i64,                         # pool FM
            i32, i32, i64, f64, i64,                         # per-level FM
            ctypes.c_uint64, p_i8,
        ]
        _lib = lib
    return _lib


def ml_bipartition(graph: HostGraph, max_block_weights, ip_ctx,
                   seed: int) -> np.ndarray:
    """Native multilevel bipartition of a non-empty HostGraph; returns an
    int8 partition.  The arguments are filled as the JAX package's
    native.ml_bipartition fills them."""
    lib = _load()
    xadj = np.ascontiguousarray(graph.xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(graph.adjncy, dtype=np.int32)
    node_w = np.ascontiguousarray(graph.node_weight_array(), dtype=np.int64)
    edge_w = np.ascontiguousarray(graph.edge_weight_array(), dtype=np.int64)
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
    ml_bipartition.calls += 1
    return out


ml_bipartition.calls = 0
