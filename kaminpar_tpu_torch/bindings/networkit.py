"""NetworKit adapter (own copy of kaminpar_tpu/bindings/networkit.py;
bindings/networkit analog).

The reference exposes `kaminpar.KaMinPar(nk_graph).computePartitionWith
Epsilon(k, eps)` through a Cython shim over a NetworKitGraphAdapter
(bindings/networkit/src/kaminpar_networkit.cc).  This module provides the
same surface: a NetworKit graph is converted to a HostGraph (edge weights
rounded to int, NetworKit's default weight 1.0 preserved exactly) and
partitioned by the facade on ``device`` (the card unless the caller asks
for the CPU).  The adapter is duck-typed: networkit itself is never
imported.
"""

from __future__ import annotations

import numpy as np

from ..graphs.host import HostGraph, from_edge_list


def networkit_to_host(nk_graph) -> HostGraph:
    """Convert a networkit.Graph (undirected) to a HostGraph.

    Duck-typed on the NetworKit graph interface (numberOfNodes /
    isDirected / isWeighted / iterEdges / weight), so it needs no import
    of networkit itself."""
    if nk_graph.isDirected():
        raise ValueError("only undirected NetworKit graphs are supported")
    n = nk_graph.numberOfNodes()
    us, vs, ws = [], [], []
    weighted = nk_graph.isWeighted()
    for u, v in nk_graph.iterEdges():
        us.append(u)
        vs.append(v)
        if weighted:
            ws.append(nk_graph.weight(u, v))
    edges = np.stack(
        [np.asarray(us, np.int64), np.asarray(vs, np.int64)], axis=1
    ) if us else np.zeros((0, 2), np.int64)
    ew = None
    if weighted and ws:
        ew = np.rint(np.asarray(ws, np.float64)).astype(np.int64)
        if (ew <= 0).any():
            raise ValueError("edge weights must round to positive integers")
    return from_edge_list(n, edges, edge_weights=ew, symmetrize=True)


class NetworKitKaMinPar:
    """Binding surface of the reference's NetworKit module:
    `KaMinPar(nk_graph).computePartitionWithEpsilon(k, eps)`."""

    def __init__(self, nk_graph, preset: str = "default", seed: int = 0,
                 device="cuda"):
        self._host = networkit_to_host(nk_graph)
        self._preset = preset
        self._seed = seed
        self._device = device

    def computePartition(self, k: int) -> np.ndarray:
        return self.computePartitionWithEpsilon(k, 0.03)

    def computePartitionWithEpsilon(self, k: int, epsilon: float) -> np.ndarray:
        from ..kaminpar import KaMinPar

        return (
            KaMinPar(self._preset, device=self._device)
            .set_graph(self._host)
            .compute_partition(k=int(k), epsilon=float(epsilon), seed=self._seed)
        )
