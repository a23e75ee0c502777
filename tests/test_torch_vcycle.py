"""The v-cycle schemes end to end: the `vcycle` and `restricted-vcycle`
presets through the facade (a deep run, then a cycle of
community-restricted LP clustering, projection down and refinement up),
and the scheme called directly from a warm start over two cycles.
kaminpar_tpu_torch's partition must equal kaminpar_tpu's bitwise.  The
harness is test_torch_schemes.py's.
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.partitioning.vcycle import (
    VcycleDeepMultilevelPartitioner as JaxVcycle,
)
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch.partitioning.vcycle import (
    VcycleDeepMultilevelPartitioner,
)
from test_torch_schemes import CASES, port_context, run_preset
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("preset", ["restricted-vcycle", "vcycle"])
def test_vcycle_bitwise_equal(preset, case):
    make, k = CASES[case]
    jpart, tpart = run_preset(preset, make(), k)
    np.testing.assert_array_equal(jpart, tpart)


def test_vcycle_warm_start_and_two_cycles():
    """Two configured cycles from a warm start (the deep run skipped),
    called on the scheme directly; a bad warm start raises."""
    make, k = CASES["rmat-k8"]  # the graph and k of the runs above
    host = make()
    warm = (np.arange(host.n) * k // host.n).astype(np.int32)
    jctx = jax_preset("vcycle")
    jctx.coarsening.contraction_limit = 160
    jctx.partitioning.vcycles = [1, 2]
    jctx.seed = 3
    jctx.partition.setup(host, k=k, epsilon=0.03)
    tctx = port_context(jctx)
    tctx.partition.setup(host, k=k, epsilon=0.03)
    jpart = JaxVcycle(jctx, initial_partition=warm).partition(host)
    tgraph = kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                          host.edge_weights)
    scheme = VcycleDeepMultilevelPartitioner(
        tctx, torch.device("cpu"), initial_partition=warm)
    tpart = scheme.partition(tgraph)
    np.testing.assert_array_equal(np.asarray(jpart), tpart)
    assert set(scheme.timings) == {"vcycle-0", "vcycle-1"}
    with pytest.raises(ValueError):
        VcycleDeepMultilevelPartitioner(
            tctx, torch.device("cpu"), initial_partition=warm[:-1]
        ).partition(tgraph)
