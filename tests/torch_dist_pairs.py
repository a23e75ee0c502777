"""Shared helpers of the port's dist test files: a JAX host graph as the
port's, and one dKaMinPar run in each package on the same graph, mesh
size, preset and seed, held bitwise."""

import numpy as np
import pytest

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.utils.logger import OutputLevel as JOL
from kaminpar_tpu.utils.logger import set_output_level as jsol
import kaminpar_tpu_torch.parallel as tp
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.utils.logger import OutputLevel as TOL
from kaminpar_tpu_torch.utils.logger import set_output_level as tsol

K = 8


def as_port(g) -> HostGraph:
    return HostGraph(xadj=g.xadj, adjncy=g.adjncy,
                     node_weights=g.node_weights,
                     edge_weights=g.edge_weights)


@pytest.fixture(scope="module")
def quiet():
    jsol(JOL.QUIET)
    tsol(TOL.QUIET)
    yield
    jsol(JOL.APPLICATION)
    tsol(TOL.APPLICATION)


def run_pair(g, D, preset="default", configure=None, k=K, seed=1,
             port_graph=None, jax_graph=None):
    """(JAX solver, port solver, partition) after asserting both
    partitions are equal; `configure(ctx, "jax" | "port")` edits each
    context before the run."""
    js = jp.dKaMinPar(preset, n_devices=D)
    ts = tp.dKaMinPar(preset, n_devices=D, device="cpu")
    if configure is not None:
        configure(js.ctx, "jax")
        configure(ts.ctx, "port")
    want = js.set_graph(g if jax_graph is None else jax_graph
                        ).compute_partition(k=k, epsilon=0.03, seed=seed)
    got = ts.set_graph(as_port(g) if port_graph is None else port_graph
                       ).compute_partition(k=k, epsilon=0.03, seed=seed)
    assert got.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)
    return js, ts, got
