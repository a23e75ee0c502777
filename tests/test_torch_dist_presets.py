"""Every dist preset this slice ports (default, fast, largek, xterapart,
europar23-fast, noref), run by the port's dKaMinPar and by the JAX
package's on the same graph and mesh: the partitions are bitwise equal.
"""

import pytest

from kaminpar_tpu.graphs import factories as jf
from torch_dist_pairs import quiet, run_pair  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("quiet")


@pytest.fixture(scope="module")
def rmat():
    return jf.make_rmat(1 << 12, 32_000, seed=3)


@pytest.mark.parametrize("preset", ["fast", "largek", "xterapart",
                                    "europar23-fast", "noref"])
def test_ported_presets_bitwise(rmat, preset):
    run_pair(rmat, 2, preset)
