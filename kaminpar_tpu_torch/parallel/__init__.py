"""Multi-shard (distributed) layer (counterpart of kaminpar_tpu/parallel).

The JAX package shards the graph over a ``jax.sharding.Mesh`` and runs
every exchange as an XLA collective inside ``shard_map``.  Here one
process drives D shards (mesh.Mesh): each round body runs shard by shard
between explicit collectives over lists of per-shard tensors, so the
result is the JAX package's bitwise at the same D.  Every name of the
JAX package's ``__all__`` is here.
"""

from .mesh import NODE_AXIS, make_mesh, make_torus_mesh
from .dist_graph import (
    DistGraph,
    dist_graph_from_compressed,
    dist_graph_from_host,
)
from .dist_lp import dist_lp_cluster, dist_lp_cluster_from, dist_lp_refine
from .dist_metrics import dist_edge_cut
from .dist_balancer import dist_node_balance
from .dist_cluster_balancer import dist_cluster_balance
from .dist_clp import dist_colored_lp_refine
from .dist_coloring import dist_greedy_coloring
from .dist_hem import dist_hem_cluster, dist_hem_lp_cluster
from .dist_jet import dist_jet_refine
from .dist_context import (
    DistClusteringAlgorithm,
    DistContext,
    DistRefinementAlgorithm,
    create_dist_clusterer,
    create_dist_context_by_preset_name,
    create_dist_refiner,
    get_dist_preset_names,
)
from .dist_partitioner import dKaMinPar


__all__ = [
    "make_mesh",
    "make_torus_mesh",
    "NODE_AXIS",
    "DistGraph",
    "dist_graph_from_compressed",
    "dist_graph_from_host",
    "dist_lp_cluster",
    "dist_lp_cluster_from",
    "dist_lp_refine",
    "dist_edge_cut",
    "dist_greedy_coloring",
    "dist_colored_lp_refine",
    "dist_node_balance",
    "dist_cluster_balance",
    "dist_jet_refine",
    "dist_hem_cluster",
    "dist_hem_lp_cluster",
    "DistContext",
    "DistClusteringAlgorithm",
    "DistRefinementAlgorithm",
    "create_dist_context_by_preset_name",
    "create_dist_clusterer",
    "create_dist_refiner",
    "get_dist_preset_names",
    "dKaMinPar",
]
