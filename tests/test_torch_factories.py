"""The port's graph factories against the JAX package's: every generator
and every `generate` spec (the CLI's `gen:` inputs) gives the same graph,
bitwise: the same CSR arrays, weights and dtypes.

An omitted seed means seed 0 in the port; the JAX package takes its
global seed, which conftest's `_seed` fixture sets to 0 for every test."""

import numpy as np
import pytest

from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu_torch.graphs import factories as tfactories
from torch_threads import one_torch_thread  # noqa: F401


def same_graph(a, b):
    for name in ("xadj", "adjncy"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for get in ("node_weight_array", "edge_weight_array"):
        assert np.array_equal(getattr(a, get)(), getattr(b, get)()), get
    assert (a.node_weights is None) == (b.node_weights is None)
    assert (a.edge_weights is None) == (b.edge_weights is None)


@pytest.mark.parametrize("name,args", [
    ("make_empty_graph", (5,)),
    ("make_path", (9,)), ("make_path", (1,)), ("make_path", (6, 3)),
    ("make_cycle", (7,)), ("make_cycle", (2,)),
    ("make_star", (6,)),
    ("make_grid_graph", (5, 7)),
    ("make_complete_graph", (6,)), ("make_complete_graph", (5, 2)),
    ("make_complete_bipartite_graph", (3, 4)),
    ("make_isolated_graph", (4,)),
    ("make_matching_graph", (5,)),
    ("make_fe_grid", (6, 9)),
    ("make_grid3d", (3, 4, 5)),
])
def test_fixture_graphs_are_the_jax_graphs(name, args):
    same_graph(getattr(jfactories, name)(*args),
               getattr(tfactories, name)(*args))


@pytest.mark.parametrize("name,args", [
    ("make_rgg3d", (2000,)), ("make_rgg3d", (1500, 12.0)),
    ("make_gnm", (1000, 5000)),
    ("make_ba", (600, 3)),
    ("make_delaunay", (1500,)),
])
@pytest.mark.parametrize("seed", [None, 5])
def test_random_generators_are_the_jax_generators(name, args, seed):
    same_graph(getattr(jfactories, name)(*args, seed=seed),
               getattr(tfactories, name)(*args, seed=seed))


@pytest.mark.parametrize("spec", [
    "gen:rmat;n=4096;m=30000;seed=3",
    "rmat;n=1024;m=8000;a=0.45;b=0.22;c=0.22;seed=9",
    "rgg2d;n=2048;avg_degree=8.0;seed=2",
    "rgg3d;n=2000;seed=1",
    "gnm;n=1000;m=5000;seed=4",
    "ba;n=500;d=3;seed=5",
    "grid2d;rows=20;cols=30",
    "grid3d;x=8;y=9;z=10",
    "delaunay;n=1500;seed=6",
    "fegrid;rows=30;cols=20",
])
def test_generate_specs_are_the_jax_graphs(spec):
    assert tfactories.parse_gen_spec(spec) == jfactories.parse_gen_spec(spec)
    same_graph(jfactories.generate(spec), tfactories.generate(spec))


def test_unknown_generator_is_refused_alike():
    messages = []
    for factories in (jfactories, tfactories):
        with pytest.raises(ValueError) as ei:
            factories.generate("gen:nope;n=5")
        messages.append(str(ei.value))
    assert messages[0] == messages[1]
