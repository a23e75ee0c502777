"""Debug dumps of graph and partition hierarchies (own copy of
kaminpar_tpu/partitioning/debug.py; kaminpar-shm/partitioning/debug.cc).

When the DebugContext flags (include/kaminpar-shm/kaminpar.h:484-496) are
set, the facade and the deep and k-way schemes write the toplevel,
coarsest and per-level graphs as METIS files and the matching partitions
as one block id per line into ``ctx.debug.dump_dir``, named
``<graph_name>.<what>.{metis,part}``: the same files, byte for byte, as
the JAX package writes.  Per-level partitions are copied to the host
after uncoarsening, not during it.
"""

from __future__ import annotations

import os

import numpy as np

from ..context import Context
from ..io.metis import write_metis
from ..io.partition import write_partition
from ..utils.logger import log_debug


def _path(ctx: Context, name: str) -> str:
    os.makedirs(ctx.debug.dump_dir, exist_ok=True)
    prefix = ctx.debug.graph_name or "graph"
    return os.path.join(ctx.debug.dump_dir, f"{prefix}.{name}")


def dump_graph(ctx: Context, host_graph, name: str) -> None:
    """debug::dump_graph analog: write a hierarchy level as METIS."""
    path = _path(ctx, f"{name}.metis")
    write_metis(host_graph, path)
    log_debug(f"[debug] dumped graph to {path}")


def dump_partition(ctx: Context, partition, name: str) -> None:
    """debug::dump_partition analog."""
    path = _path(ctx, f"{name}.part")
    write_partition(path, np.asarray(partition))
    log_debug(f"[debug] dumped partition to {path}")


def dump_toplevel_graph(ctx: Context, host_graph) -> None:
    if ctx.debug.dump_toplevel_graph:
        dump_graph(ctx, host_graph, "toplevel")


def dump_toplevel_partition(ctx: Context, partition) -> None:
    if ctx.debug.dump_toplevel_partition:
        dump_partition(ctx, partition, "toplevel")


def dump_coarsest_graph(ctx: Context, host_graph) -> None:
    if ctx.debug.dump_coarsest_graph:
        dump_graph(ctx, host_graph, "coarsest")


def dump_coarsest_partition(ctx: Context, partition) -> None:
    if ctx.debug.dump_coarsest_partition:
        dump_partition(ctx, partition, "coarsest")


def dump_graph_hierarchy(ctx: Context, host_graph, level: int) -> None:
    if ctx.debug.dump_graph_hierarchy:
        dump_graph(ctx, host_graph, f"level{level}")


def dump_partition_hierarchy(ctx: Context, partition, level: int) -> None:
    if ctx.debug.dump_partition_hierarchy:
        dump_partition(ctx, partition, f"level{level}")
