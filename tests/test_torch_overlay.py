"""Overlay (PASCO) and `noop` coarsening in the port.

`ops.segments.combine_labels` intersects two clusterings and must give
kaminpar_tpu's labels bitwise, on ties and on skewed label distributions.
Overlay coarsening intersects `num_overlays` LP clusterings per level, and
`noop` clusters as plain LP, as in the JAX coarsener: the facade's
partitions under both equal the JAX package's bitwise.  The harness is
test_torch_schemes.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.context import CoarseningAlgorithm
from kaminpar_tpu.ops.segments import combine_labels as jax_combine
from kaminpar_tpu_torch.ops.segments import combine_labels
from test_torch_schemes import CASES, run_preset
from torch_threads import one_torch_thread  # noqa: F401


def _labels(kind: str, n: int, rng) -> np.ndarray:
    if kind == "ties":  # few labels: large groups, many equal keys
        return rng.integers(0, 4, n).astype(np.int32)
    if kind == "skewed":  # one label holds most nodes, a long tail
        out = np.zeros(n, dtype=np.int32)
        tail = rng.random(n) < 0.2
        out[tail] = rng.integers(0, n, int(tail.sum()))
        return out
    if kind == "identity":
        return np.arange(n, dtype=np.int32)
    return rng.integers(0, n, n).astype(np.int32)  # "uniform"


@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
@pytest.mark.parametrize("kinds", [("ties", "ties"), ("ties", "skewed"),
                                   ("skewed", "uniform"),
                                   ("identity", "ties"),
                                   ("uniform", "uniform")])
def test_combine_labels_bitwise(kinds, n):
    rng = np.random.default_rng(n + 17 * len(kinds[0]) + len(kinds[1]))
    l1, l2 = (_labels(kind, n, rng) for kind in kinds)
    ref = np.asarray(jax_combine(jnp.asarray(l1), jnp.asarray(l2)))
    out = combine_labels(torch.from_numpy(l1), torch.from_numpy(l2))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # nodes share an output label iff they share both input labels
    pairs = l1.astype(np.int64) * n + l2
    _, first = np.unique(pairs, return_index=True)
    assert len(np.unique(ref)) == len(first)


def _algorithm(algorithm, num_overlays=None):
    def configure(ctx):
        ctx.coarsening.algorithm = algorithm
        if num_overlays is not None:
            ctx.coarsening.clustering.num_overlays = num_overlays
    return configure


RUNS = {
    "overlay": _algorithm(CoarseningAlgorithm.OVERLAY_CLUSTERING),
    "overlay-3": _algorithm(CoarseningAlgorithm.OVERLAY_CLUSTERING, 3),
    "noop": _algorithm(CoarseningAlgorithm.NOOP),
}


@pytest.mark.parametrize("run,case", [
    ("overlay", "rmat-k8"), ("overlay", "rgg-k4"),
    ("overlay-3", "rmat-k8"), ("noop", "rgg-k4"),
])
def test_coarsening_algorithm_bitwise_equal(run, case):
    make, k = CASES[case]
    jpart, tpart = run_preset("default", make(), k, RUNS[run])
    np.testing.assert_array_equal(jpart, tpart)
