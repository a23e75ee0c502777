"""More presets end to end through the facade, bitwise against the JAX
package on make_rmat(1 << 12, 30_000, seed=3) at k=8: `largek`, `jet`,
`4xjet` and `linear-time-kway` (sparsification clustering), and `default`
with the host extension's worker pool at 1 and 4 workers (per-block seeds
drawn before the pool runs).  The harness is test_torch_schemes.py's.
"""

import numpy as np
import pytest

import kaminpar_tpu_torch.partitioning.deep as tdeep
from test_torch_schemes import CASES, run_preset
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("preset",
                         ["4xjet", "jet", "largek", "linear-time-kway"])
def test_preset_bitwise_equal(preset):
    make, k = CASES["rmat-k8"]
    jpart, tpart = run_preset(preset, make(), k)
    np.testing.assert_array_equal(jpart, tpart)


@pytest.mark.parametrize("workers", [1, 4])
def test_deep_worker_pool_bitwise_equal(workers, monkeypatch):
    pools = []

    class CountedPool(tdeep.ThreadPoolExecutor):
        def __init__(self, max_workers):
            pools.append(max_workers)
            super().__init__(max_workers=max_workers)

    monkeypatch.setattr(tdeep, "ThreadPoolExecutor", CountedPool)

    def configure(ctx):
        ctx.parallel.num_workers = workers

    make, k = CASES["rmat-k8"]
    jpart, tpart = run_preset("default", make(), k, configure)
    np.testing.assert_array_equal(jpart, tpart)
    assert pools == ([] if workers == 1 else [workers] * len(pools))
    assert bool(pools) == (workers > 1)
