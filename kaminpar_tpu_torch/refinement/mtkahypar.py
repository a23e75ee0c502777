"""Gated Mt-KaHyPar refinement adapter (counterpart of
kaminpar_tpu/refinement/mtkahypar.py; mtkahypar_refiner.cc:182).

The reference optionally delegates refinement to the external Mt-KaHyPar
library behind a build flag; without it the refiner slot exists but
selecting it fails.  Here: when the `mtkahypar` Python package is
importable, the host partition is handed to it for k-way refinement with
node weights, edge weights and the per-block caps; otherwise selecting the
`mtkahypar` refinement algorithm raises with a clear message.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..graphs.host import HostGraph

# (threads, Mt-KaHyPar instance): the library is initialized once per
# process and thread count
_MTK_INSTANCE = None


def mtkahypar_refine_host(
    host_graph: HostGraph,
    partition: np.ndarray,
    k: int,
    max_block_weights: Optional[Sequence[int]] = None,
    epsilon: float = 0.03,
    seed: int = 0,
    threads: int = 1,
) -> np.ndarray:
    """Improve `partition` with Mt-KaHyPar's k-way refinement.  Requires
    the external `mtkahypar` package; `max_block_weights` (when given) is
    forwarded as individual target block weights, else `epsilon`."""
    try:
        import mtkahypar
    except ImportError as e:
        raise RuntimeError(
            "the 'mtkahypar' refiner needs the external mtkahypar package "
            "(reference analog: built without KAMINPAR_BUILD_WITH_MTKAHYPAR)"
        ) from e

    global _MTK_INSTANCE
    if _MTK_INSTANCE is None or _MTK_INSTANCE[0] != threads:
        _MTK_INSTANCE = (threads, mtkahypar.initialize(int(threads)))
    mtk = _MTK_INSTANCE[1]
    ctx = mtk.context_from_preset(mtkahypar.PresetType.DEFAULT)
    ctx.set_partitioning_parameters(k, float(epsilon), mtkahypar.Objective.CUT)
    if max_block_weights is not None:
        ctx.set_individual_target_block_weights(
            [int(w) for w in max_block_weights]
        )
    mtkahypar.set_seed(int(seed))

    src = host_graph.edge_sources()
    dst = host_graph.adjncy
    ew = host_graph.edge_weight_array()
    fwd = src < dst  # one record per undirected edge, weight preserved
    g = mtk.create_graph(
        ctx,
        int(host_graph.n),
        int(fwd.sum()),
        [(int(u), int(v)) for u, v in zip(src[fwd], dst[fwd])],
        [int(w) for w in host_graph.node_weight_array()],
        [int(w) for w in ew[fwd]],
    )
    pg = g.create_partitioned_graph(k, [int(b) for b in partition])
    pg.improve_partition(ctx, 1)
    return np.asarray(
        [pg.block_id(u) for u in range(host_graph.n)], dtype=np.int32
    )
