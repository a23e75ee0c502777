"""The port's dKaMinPar (kaminpar_tpu_torch/parallel/dist_partitioner.py)
against the JAX package's on the 8-device CPU mesh: the partition is
bitwise equal at D in {1, 2, 8} and on a (2, 4) grid, with mesh-subgroup
replication firing at D = 8; every JAX preset is known and builds its
clusterer and refiners.  The other presets and the pipeline's variants
are in test_torch_dist_presets.py, test_torch_dist_refiners.py and
test_torch_dist_pipeline.py.
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu.parallel as jp
from kaminpar_tpu.graphs import factories as jf
import kaminpar_tpu_torch.parallel as tp
from torch_dist_pairs import K, as_port, quiet, run_pair  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("quiet")


@pytest.fixture(scope="module")
def rmat():
    return jf.make_rmat(1 << 12, 32_000, seed=3)


@pytest.mark.parametrize("D", [1, 2, 8, (2, 4)])
def test_default_bitwise_at_every_mesh(rmat, D):
    js, ts, part = run_pair(rmat, D)
    assert ((part >= 0) & (part < K)).all()
    # replication fires below 2048 nodes per shard: at D = 8 the input
    # itself (4096 nodes) is split into replicas
    size = D if isinstance(D, int) else D[0] * D[1]
    fired = ts._replication_info is not None
    assert fired == (js._replication_info is not None)
    assert fired == (size == 8)
    if fired:
        assert ts._replication_info == js._replication_info
    assert ts.last_timings["total"] > 0
    G = ts._replication_info["G"] if fired else 1
    assert ts.last_levels[0]["n"] == G * rmat.n


def test_every_jax_preset_is_known():
    assert tp.get_dist_preset_names() == jp.get_dist_preset_names()
    for name in sorted(tp.get_dist_preset_names()):
        ctx = tp.create_dist_context_by_preset_name(name)
        # every clusterer and refiner of every preset has its module
        tp.create_dist_clusterer(ctx)
        tp.create_dist_refiner(ctx)
    with pytest.raises(ValueError, match="unknown dist preset"):
        tp.create_dist_context_by_preset_name("nope")


def test_tiny_graph_takes_the_shm_fallback():
    g = jf.make_grid_graph(6, 6)
    run_pair(g, 2, k=4)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tp.dKaMinPar("default", n_devices=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.dKaMinPar("default", n_devices=2)


@pytest.mark.cuda
def test_card_partition_equals_cpu(rmat):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and run the "
                    "CUDA kernels")
    g = as_port(rmat)
    parts = [tp.dKaMinPar("default", n_devices=8, device=dev).set_graph(g)
             .compute_partition(k=K, epsilon=0.03, seed=1)
             for dev in ("cpu", "cuda")]
    np.testing.assert_array_equal(parts[0], parts[1])
