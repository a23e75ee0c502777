"""Recursive bipartitioning on the host (counterpart of
kaminpar_tpu/partitioning/rb.py; rb_multilevel.cc and helper.cc:104-147).

`recursive_bipartition` splits a graph into k blocks by recursive calls of
the multilevel bipartitioner, each bisection's two sides capped by the sums
of their final sub-blocks' unrelaxed max weights, tightened by the
adaptive-epsilon rule (`bipartition_max_block_weights`).  `split_k` halves a
block count.
"""

from __future__ import annotations

import math as pymath
from typing import Optional

import numpy as np

from ..context import Context
from ..graphs.host import HostGraph, extract_block_subgraphs
from ..initial import InitialMultilevelBipartitioner
from ..utils.rng import host_rng
from .. import telemetry


def split_k(k: int) -> tuple:
    """split_integral for block counts: ceil/floor halves."""
    k0 = (k + 1) // 2
    return k0, k - k0


def bipartition_max_block_weights(
    ctx: Context,
    first_sub_block: int,
    num_sub_blocks: int,
    graph_total_node_weight: int,
) -> np.ndarray:
    """Max weights for one 2-way split covering final blocks
    [first_sub_block, first_sub_block + num_sub_blocks), with the
    adaptive-epsilon tightening for uniform block weights."""
    p = ctx.partition
    k0, k1 = split_k(num_sub_blocks)
    w0 = p.total_max_block_weights(first_sub_block, first_sub_block + k0)
    w1 = p.total_max_block_weights(
        first_sub_block + k0, first_sub_block + num_sub_blocks
    )
    max_weights = np.array([w0, w1], dtype=np.int64)

    if p.uniform_block_weights and ctx.initial_partitioning.use_adaptive_epsilon:
        base = (
            (1.0 + p.inferred_epsilon())
            * num_sub_blocks
            * p.total_node_weight
            / p.k
            / max(graph_total_node_weight, 1)
        )
        exponent = 1.0 / max(pymath.ceil(pymath.log2(max(num_sub_blocks, 2))), 1)
        adapted_eps = max(base**exponent - 1.0, 0.0001)
        total = int(max_weights.sum())
        ratios = max_weights / max(total, 1)
        perfect = graph_total_node_weight * ratios
        max_weights = np.ceil((1.0 + adapted_eps) * perfect).astype(np.int64)
    return max_weights


def recursive_bipartition(
    graph: HostGraph,
    k: int,
    ctx: Context,
    rng: Optional[np.random.Generator] = None,
    first_sub_block: int = 0,
) -> np.ndarray:
    """Partition `graph` into its final blocks [first_sub_block,
    first_sub_block + k) by recursive bisection; returns block ids
    relative to first_sub_block, 0 .. k-1."""
    if rng is None:
        rng = host_rng(ctx.seed, ctx.seed)
    part = np.zeros(graph.n, dtype=np.int32)
    if k <= 1 or graph.n == 0:
        return part

    telemetry.event(
        "rb-bisection", n=int(graph.n), k=int(k),
        first_sub_block=int(first_sub_block),
    )
    max_weights = bipartition_max_block_weights(
        ctx, first_sub_block, k, graph.total_node_weight
    )
    bipart = InitialMultilevelBipartitioner(
        ctx.initial_partitioning
    ).bipartition(graph, max_weights, rng)
    k0, k1 = split_k(k)
    if k0 == 1 and k1 == 1:
        return bipart.astype(np.int32)

    ext = extract_block_subgraphs(graph, bipart.astype(np.int64), 2)
    sub0 = recursive_bipartition(
        ext.subgraphs[0], k0, ctx, rng, first_sub_block
    )
    sub1 = recursive_bipartition(
        ext.subgraphs[1], k1, ctx, rng, first_sub_block + k0
    )
    in0 = bipart == 0
    part[in0] = sub0[ext.node_mapping[in0]]
    part[~in0] = k0 + sub1[ext.node_mapping[~in0]]
    return part
