"""Python side of the C ABI (own copy of kaminpar_tpu/capi.py;
kaminpar-shm/ckaminpar.cc analog).

Called by the interpreter that native/ckaminpar.cpp embeds: the C
caller's CSR pointers are wrapped as numpy arrays without copying, the
facade runs, and the partition is written straight into the caller's
output buffer.  The C interface (include/ckaminpar_tpu.h) has no device
argument: the partition is computed on the card unless
``KAMINPAR_TPU_PLATFORM=cpu`` asks for the CPU (any other value means the
card), and without a card the call fails (-1, ``kmp_last_error`` names
the cause).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

PLATFORM_ENV = "KAMINPAR_TPU_PLATFORM"


def _as_array(ptr: int, dtype, count: int):
    if ptr == 0 or count == 0:
        return None
    ct = ctypes.POINTER(ctypes.c_int64 if dtype == np.int64 else ctypes.c_int32)
    return np.ctypeslib.as_array(ctypes.cast(ptr, ct), shape=(count,))


def device_from_env() -> str:
    """``"cpu"`` when KAMINPAR_TPU_PLATFORM says so, else ``"cuda"``."""
    return ("cpu" if os.environ.get(PLATFORM_ENV, "").strip() == "cpu"
            else "cuda")


def compute_from_pointers(
    n: int,
    xadj_ptr: int,
    adjncy_ptr: int,
    vwgt_ptr: int,
    adjwgt_ptr: int,
    out_ptr: int,
    k: int,
    epsilon: float,
    seed: int,
    preset: str,
) -> int:
    """Partition the CSR graph at the given addresses; returns the cut."""
    from .graphs.host import HostGraph
    from .kaminpar import KaMinPar

    xadj = _as_array(xadj_ptr, np.int64, n + 1)
    if xadj is None:
        xadj = np.zeros(1, dtype=np.int64)
    m = int(xadj[n]) if n > 0 else 0
    adjncy = _as_array(adjncy_ptr, np.int32, m)
    if adjncy is None:
        adjncy = np.zeros(0, dtype=np.int32)
    vwgt = _as_array(vwgt_ptr, np.int32, n)
    adjwgt = _as_array(adjwgt_ptr, np.int32, m)

    graph = HostGraph(
        xadj=np.asarray(xadj, dtype=np.int64).copy(),
        adjncy=np.asarray(adjncy, dtype=np.int32).copy(),
        node_weights=None if vwgt is None else np.asarray(vwgt, np.int64).copy(),
        edge_weights=None if adjwgt is None else np.asarray(adjwgt, np.int64).copy(),
    )
    part = (
        KaMinPar(preset, device=device_from_env())
        .set_graph(graph)
        .compute_partition(k=int(k), epsilon=float(epsilon), seed=int(seed))
    )
    out = _as_array(out_ptr, np.int32, n)
    if out is not None:
        out[:] = np.asarray(part, dtype=np.int32)[:n]

    src = graph.edge_sources()
    ew = graph.edge_weight_array()
    cut = int(((part[src] != part[graph.adjncy]) * ew).sum()) // 2
    return cut
