"""Strict-balance output gate (counterpart of kaminpar_tpu/resilience/gate.py).

The facade routes its result through `check_and_repair`: the gate
recomputes block weights and the cut on the host with its own numpy code,
checks every label is in [0, k) and every block is within its cap (the
unrelaxed (1 + eps) * ceil(n / k) caps for unit node weights and uniform
blocks, the relaxed caps otherwise), and repairs a violation with the
exact greedy host balancer.  The verdict is returned as a dict and
recorded as an `output-gate` telemetry event.

Compressed inputs and generator-spec graphs are checked chunk by chunk
(decoded or regenerated node ranges), so the check never builds the
flat edge list; only a needed repair decodes the whole graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import telemetry
from ..utils.logger import log_warning

#: Nodes per decode chunk when recomputing metrics on compressed inputs.
CHUNK_NODES = 1 << 18


def _crossing_weight(partition, v0, v1, deg, adj, ew) -> int:
    owner = np.repeat(np.arange(v0, v1, dtype=np.int64), deg)
    crosses = partition[owner] != partition[np.asarray(adj)]
    if ew is None:
        return int(np.count_nonzero(crosses))
    return int(np.asarray(ew, dtype=np.int64)[crosses].sum())


def recompute_metrics(graph, partition: np.ndarray, k: int) -> Tuple[int, np.ndarray]:
    """(cut, block_weights) recomputed on the host; compressed and
    generator-spec graphs chunk by chunk."""
    from ..graphs.compressed import CompressedHostGraph

    partition = np.asarray(partition)
    bw = np.zeros(max(k, 1), dtype=np.int64)
    np.add.at(
        bw,
        np.clip(partition, 0, max(k - 1, 0)),
        np.asarray(graph.node_weight_array(), dtype=np.int64),
    )
    cut2 = 0  # both directions of every cut edge
    if hasattr(graph, "iter_rows"):
        # generator-spec graph (external/chunkstore.StreamedSpecGraph)
        for v0, v1, adj, ew in graph.iter_rows():
            deg = np.asarray(graph.xadj[v0 + 1: v1 + 1] - graph.xadj[v0:v1],
                             dtype=np.int64)
            cut2 += _crossing_weight(partition, v0, v1, deg, adj, ew)
    elif isinstance(graph, CompressedHostGraph):
        for v0 in range(0, graph.n, CHUNK_NODES):
            v1 = min(graph.n, v0 + CHUNK_NODES)
            xr, adj, ew = graph.decode_range(v0, v1)
            deg = np.diff(np.asarray(xr, dtype=np.int64))
            cut2 += _crossing_weight(partition, v0, v1, deg, adj, ew)
    elif graph.m:
        xadj = np.asarray(graph.xadj, dtype=np.int64)
        owner = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(xadj))
        crosses = partition[owner] != partition[graph.adjncy]
        ew = graph.edge_weight_array()
        cut2 += int(np.asarray(ew, dtype=np.int64)[crosses].sum())
    return cut2 // 2, bw


def _strict_caps(graph, p_ctx) -> Tuple[np.ndarray, str]:
    node_w = np.asarray(graph.node_weight_array())
    unit = bool((node_w == 1).all()) if node_w.size else True
    unrelaxed = p_ctx.unrelaxed_max_block_weights
    if unit and p_ctx.uniform_block_weights and unrelaxed is not None:
        return np.asarray(unrelaxed, dtype=np.int64), "strict-unit"
    return np.asarray(p_ctx.max_block_weights, dtype=np.int64), "relaxed"


def check_and_repair(
    graph,
    partition: np.ndarray,
    p_ctx,
    *,
    repair: bool = True,
    reported_cut: Optional[int] = None,
) -> Tuple[np.ndarray, dict]:
    """Validate (and, on violation, repair) a finished partition; returns
    (partition, verdict)."""
    k = int(p_ctx.k)
    n = int(graph.n)
    part = np.asarray(partition)
    violations = []
    if part.shape != (n,):
        raise ValueError(
            f"partition has {part.shape} entries, graph has {n} nodes"
        )
    out_of_range = (part < 0) | (part >= k)
    num_oor = int(out_of_range.sum())
    if num_oor:
        violations.append(f"assignment: {num_oor} node(s) outside [0, {k})")
    caps, cap_basis = _strict_caps(graph, p_ctx)
    repaired = False
    moved = 0
    if num_oor and repair:
        part = part.copy()
        _, bw0 = recompute_metrics(graph, np.where(out_of_range, 0, part), k)
        part[out_of_range] = int(np.argmin(bw0))
        repaired = True
    cut, bw = recompute_metrics(graph, np.clip(part, 0, k - 1), k)
    cut_match = None if reported_cut is None else bool(cut == int(reported_cut))
    if cut_match is False:
        violations.append(
            f"cut-mismatch: reported {int(reported_cut)}, recomputed {cut}"
        )
    overload = int(np.maximum(bw - caps, 0).sum())
    if overload:
        violations.append(
            f"balance: total overload {overload} over the {cap_basis} caps"
        )
    if overload and repair:
        part = _greedy_repair(graph, np.clip(part, 0, k - 1), caps)
        repaired = True
    if repaired:
        part = np.ascontiguousarray(part, dtype=np.int32)
        cut, bw = recompute_metrics(graph, part, k)
        overload = int(np.maximum(bw - caps, 0).sum())
        moved = int(np.count_nonzero(part != np.asarray(partition)))
        valid = overload == 0 and not ((part < 0) | (part >= k)).any()
    else:
        part = partition
        valid = overload == 0 and num_oor == 0
    perfect = max(1, -(-int(np.asarray(graph.node_weight_array(),
                                       dtype=np.int64).sum()) // max(k, 1)))
    verdict = {
        "checked": True,
        "valid": bool(valid),
        "violations": violations,
        "repaired": repaired,
        "repair_moves": moved,
        "cut_reported": None if reported_cut is None else int(reported_cut),
        "cut_recomputed": int(cut),
        "cut_match": cut_match,
        "imbalance": float(bw.max() / perfect - 1.0) if k else 0.0,
        "max_overload": overload,
        "cap_basis": cap_basis,
    }
    telemetry.event("output-gate", **verdict)
    if repaired or violations:
        log_warning(
            "output gate: " + "; ".join(violations)
            + (f" -> repaired ({moved} node(s) moved)" if repaired else
               " (repair disabled)")
        )
    return part, verdict


def _greedy_repair(graph, part: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """The exact greedy host balancer over the gate's caps.  Decodes a
    compressed input (or generates a spec graph) first: repair is the
    rare path, the check itself streams."""
    from ..graphs.compressed import CompressedHostGraph
    from ..ops.balancer import host_balance

    if isinstance(graph, CompressedHostGraph):
        host = graph.decode()
    elif hasattr(graph, "to_host_graph"):
        host = graph.to_host_graph()
    else:
        host = graph
    return host_balance(
        np.asarray(host.node_weight_array(), dtype=np.int64),
        (
            np.asarray(host.xadj, dtype=np.int64),
            np.asarray(host.adjncy),
            np.asarray(host.edge_weight_array(), dtype=np.int64),
        ),
        np.ascontiguousarray(part, dtype=np.int32),
        caps,
    )
