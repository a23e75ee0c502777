"""Kill and resume, and the anytime wind-down, of the port's other
schemes against the JAX package's, at zero tolerance: a hard stop at one
barrier of k-way (`uncoarsen:1!`), v-cycle (`vcycle:0!`) and external (a
streamed level, `stream-coarsen:0!`, and its in-core phase,
`uncoarsen:1!`) and a resume give both packages the uninterrupted
partition; RB's soft stop at `rb-toplevel` skips its top-level refinement
in both.  The deep scheme's barriers are in test_torch_checkpoint.py.
"""

import numpy as np
import pytest

from kaminpar_tpu.context import PartitioningMode as JMode
from kaminpar_tpu.graphs import factories as jfactories
from test_torch_checkpoint import K, kill_and_resume
from test_torch_resilience import (  # noqa: F401
    _clean,
    assert_same,
    run_one,
    run_pair,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def small():
    return jfactories.make_rmat(1 << 12, 30_000, seed=3)


@pytest.mark.parametrize("preset,stop,mode", [
    ("mtkahypar-kway", "uncoarsen:1!", None),
    ("vcycle", "vcycle:0!", None),
    ("default", "stream-coarsen:0!", "external"),
    ("default", "uncoarsen:1!", "external"),
], ids=["kway", "vcycle", "external-stream", "external-incore"])
def test_scheme_kill_and_resume_bitwise(small, tmp_path, preset, stop, mode):
    def configure(ctx):
        if mode == "external":
            ctx.partitioning.mode = JMode.EXTERNAL

    base = run_one("jax", preset, small, K, configure=configure)
    j, t = kill_and_resume(preset, small, stop, tmp_path,
                           configure=configure)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, base.part)
    assert t.events["resume"] == j.events["resume"]
    if mode == "external":
        assert t.solver.last_external["resumed_levels"] == 1



def test_rb_soft_stop_skips_the_toplevel_refinement(small):
    def configure(ctx):
        ctx.partitioning.mode = JMode.RB
        ctx.partitioning.rb_enable_kway_toplevel_refinement = True

    j, t = run_pair("default", small, K, configure=configure,
                    env={"KAMINPAR_TPU_STOP_AT": "rb-toplevel"})
    assert_same(j, t)
    assert t.solver.last_anytime["stage"] == "rb-toplevel"
    plain = run_one("jax", "default", small, K, configure=lambda c: (
        setattr(c.partitioning, "mode", JMode.RB)))
    np.testing.assert_array_equal(t.part, plain.part)
