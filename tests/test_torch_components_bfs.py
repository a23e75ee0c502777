"""The device ops `connected_components` and `bfs_hops` against the JAX
package's, at zero tolerance, on graphs with many components and isolated
nodes (sparse RMAT, a random forest of paths), with seed sets that hold
out-of-range entries and hop caps from 0 to past the diameter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.graphs import csr as jcsr
from kaminpar_tpu.graphs.factories import make_rmat
from kaminpar_tpu.graphs.host import from_edge_list
from kaminpar_tpu.ops import bfs as jbfs
from kaminpar_tpu.ops import components as jcomponents
from kaminpar_tpu_torch.graphs.csr import device_graph_from_host
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.ops import bfs as tbfs
from kaminpar_tpu_torch.ops import components as tcomponents
from torch_threads import one_torch_thread  # noqa: F401


def _paths(n=3000, seed=4):
    """Disjoint paths of random lengths over a random node order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cut = rng.random(n - 1) < 0.02
    edges = np.stack([order[:-1], order[1:]], axis=1)[~cut]
    return from_edge_list(n, edges)


GRAPHS = {
    "rmat-sparse": lambda: make_rmat(1 << 12, 2_500, seed=5),
    "rmat": lambda: make_rmat(1 << 11, 12_000, seed=3),
    "paths": _paths,
}


def _both(name):
    g = GRAPHS[name]()
    return jcsr.device_graph_from_host(g), device_graph_from_host(
        HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights), "cpu"), g


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_connected_components_equal_jax(name):
    jdg, tdg, g = _both(name)
    j = np.asarray(jcomponents.connected_components(jdg))
    t = tcomponents.connected_components(tdg).numpy()
    np.testing.assert_array_equal(t, j)
    count = tcomponents.count_components(tdg)
    assert count == jcomponents.count_components(jdg)
    assert 1 < count < g.n


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("max_hops", [0, 1, 3, 1000])
def test_bfs_hops_equal_jax(name, max_hops):
    jdg, tdg, g = _both(name)
    seeds = np.array([0, -1, 17, g.n + 5, g.n - 1, 17], dtype=np.int32)
    j = np.asarray(jbfs.bfs_hops(jdg, jnp.asarray(seeds),
                                 jnp.int32(max_hops)))
    t = tbfs.bfs_hops(tdg, torch.from_numpy(seeds), max_hops).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t[g.n:] == tbfs.UNREACHED).all()
    assert t[0] == 0 and t[17] == 0
