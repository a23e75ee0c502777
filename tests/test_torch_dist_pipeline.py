"""The dist pipeline's variants, port against JAX package, bitwise: the
scatter rating engine (the standalone K3 on the path), local-lp
clustering (K3 with a label range), the k-way mode, the RANDOM initial
partitioner, the forced sharded contraction, a compressed input and
copy_graph.
"""

import numpy as np
import pytest

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.context import PartitioningMode as JMode
from kaminpar_tpu.graphs import factories as jf
from kaminpar_tpu.graphs.compressed import compress_host_graph as jcompress
from kaminpar_tpu.parallel import dist_partitioner as jdp
from kaminpar_tpu.parallel.dist_context import (
    DistClusteringAlgorithm as JClu,
    DistInitialPartitioningAlgorithm as JIP,
)
import kaminpar_tpu_torch.parallel as tp
from kaminpar_tpu_torch.context import PartitioningMode as TMode
from kaminpar_tpu_torch.graphs.compressed import compress_host_graph
from kaminpar_tpu_torch.parallel import dist_partitioner as tdp
from kaminpar_tpu_torch.parallel.dist_context import (
    DistClusteringAlgorithm as TClu,
    DistInitialPartitioningAlgorithm as TIP,
)
from torch_dist_pairs import as_port, quiet, run_pair  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("quiet")


@pytest.fixture(scope="module")
def rmat():
    return jf.make_rmat(1 << 12, 32_000, seed=3)


@pytest.mark.parametrize("case", ["scatter", "local-lp", "kway", "random"])
def test_pipeline_variants_bitwise(rmat, case):
    def configure(ctx, which):
        if case == "scatter":
            ctx.lp_rating = "scatter"
        elif case == "local-lp":
            ctx.lp_rating = "scatter"
            ctx.clustering = (JClu if which == "jax" else TClu).LOCAL_LP
        elif case == "kway":
            ctx.mode = (JMode if which == "jax" else TMode).KWAY
        else:
            ctx.initial_partitioning = (JIP if which == "jax"
                                        else TIP).RANDOM
    run_pair(rmat, 8 if case != "kway" else 2, configure=configure)


def test_forced_sharded_contraction_bitwise(rmat, monkeypatch):
    monkeypatch.setattr(jdp, "MAX_FUSED_EDGE_SLOTS", 0)
    monkeypatch.setattr(tdp, "MAX_FUSED_EDGE_SLOTS", 0)
    calls = []
    real = tdp.dist_contract_clustering

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tdp, "dist_contract_clustering", spy)
    run_pair(rmat, 2)
    assert calls


def test_compressed_input_bitwise(rmat):
    _, ts, _ = run_pair(rmat, 2, jax_graph=jcompress(rmat),
                        port_graph=compress_host_graph(as_port(rmat)))
    assert ts._is_compressed(ts._graph)


def test_copy_graph_bitwise():
    g = jf.make_grid_graph(40, 40)
    js = jp.dKaMinPar("default", n_devices=2)
    ts = tp.dKaMinPar("default", n_devices=2, device="cpu")
    vtx = [0, g.n // 2, g.n]
    want = js.copy_graph(vtx, g.xadj, g.adjncy).compute_partition(k=4,
                                                                 seed=3)
    got = ts.copy_graph(vtx, g.xadj, g.adjncy).compute_partition(k=4, seed=3)
    np.testing.assert_array_equal(got, want)
