"""The port's dist resilience layer against the JAX package's: the same
uninterrupted dist run gives the same partition; a run hard-killed at
every dist barrier kind resumes to that partition; a resume under another
shard count restarts clean; the agreed OOM ladder (an injected OOM, forced
rungs 2 and host-only) gives the JAX package's partitions; rank-scoped
fault addressing fires on its rank only; the divergence sentinels turn a
skewed (simulated) fleet into a RankDivergence with the per-rank dump.
"""

import json
import os

import numpy as np
import pytest

import kaminpar_tpu.parallel as jp
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs.factories import make_grid_graph, make_star
from kaminpar_tpu.parallel.dist_context import (
    create_dist_context_by_preset_name as jctx,
)
import kaminpar_tpu_torch.parallel as tp
from kaminpar_tpu_torch import resilience, telemetry
from kaminpar_tpu_torch.parallel.dist_context import (
    create_dist_context_by_preset_name as tctx,
)
from kaminpar_tpu_torch.parallel.dist_graph import shard_sizes
from kaminpar_tpu_torch.resilience import agreement, faults
from kaminpar_tpu_torch.resilience import checkpoint as ckpt_mod
from kaminpar_tpu_torch.resilience import memory as memory_mod
from kaminpar_tpu_torch.resilience.checkpoint import SimulatedPreemption
from kaminpar_tpu_torch.resilience.errors import DeviceOOM, RankDivergence
from kaminpar_tpu_torch.telemetry.report import (
    build_run_report,
    validate_report,
)
from torch_dist_pairs import as_port
from torch_threads import one_torch_thread  # noqa: F401

GRID = 32
K = 4
CONTRACTION_LIMIT = 30
ENV = (ckpt_mod.STOP_AT_ENV, resilience.FAULTS_ENV_VAR,
       agreement.ENV_SIM_RANK, agreement.ENV_SIM_RANKS,
       memory_mod.ENV_FORCE_RUNG, memory_mod.ENV_BUDGET)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    resilience.reset()
    telemetry.reset()
    telemetry.enable()
    yield
    resilience.reset()
    jres.reset()
    telemetry.disable()
    telemetry.reset()
    jtel.disable()
    jtel.reset()


def _run(pkg="port", ckpt=None, resume=False, stop_at=None, n_devices=4,
         env=None, gather=None):
    """One dist deep run (>= 2 levels, no replication) of `pkg`."""
    res, tel = (resilience, telemetry) if pkg == "port" else (jres, jtel)
    res.reset()
    tel.reset()
    tel.enable()
    if gather is not None:
        (agreement if pkg == "port" else jres.agreement
         ).set_gather_override(gather)
    env = dict(env or {})
    if stop_at is not None:
        env[ckpt_mod.STOP_AT_ENV] = stop_at
    ctx = (tctx if pkg == "port" else jctx)("default")
    ctx.shm.coarsening.contraction_limit = CONTRACTION_LIMIT
    ctx.replication_min_nodes_per_device = 0
    if ckpt is not None:
        ctx.shm.resilience.checkpoint_dir = str(ckpt)
        ctx.shm.resilience.resume = resume
    g = make_grid_graph(GRID, GRID)
    if pkg == "port":
        solver = tp.dKaMinPar(ctx, mesh=tp.make_mesh(n_devices,
                                                     device="cpu"))
        solver.set_graph(as_port(g))
    else:
        solver = jp.dKaMinPar(ctx, mesh=jp.make_mesh(n_devices))
        solver.set_graph(g)
    os.environ.update(env)
    try:
        part = solver.compute_partition(k=K, epsilon=0.03, seed=1)
    finally:
        for var in env:
            os.environ.pop(var, None)
    return solver, g, np.asarray(part)


@pytest.fixture(scope="module")
def baseline():
    """The uninterrupted run's partition; the two packages agree on it."""
    try:
        _, _, want = _run("jax")
        _, _, got = _run("port")
        np.testing.assert_array_equal(got, want)
        return got
    finally:
        resilience.reset()
        jres.reset()
        telemetry.reset()
        jtel.reset()


def _gate_valid() -> bool:
    gates = telemetry.events("output-gate")
    assert gates, "no output-gate event"
    return bool(gates[-1].attrs["valid"])


# -- checkpoints and resume ------------------------------------------------


@pytest.mark.parametrize(
    "stop_at",
    ["dist-coarsen:1!", "dist-initial!", "dist-uncoarsen:1!",
     "dist-uncoarsen:0!"],
)
def test_kill_and_resume_is_cut_identical(tmp_path, baseline, stop_at):
    d = tmp_path / "ckpt"
    with pytest.raises(SimulatedPreemption):
        _run(ckpt=d, stop_at=stop_at)
    _, _, part = _run(ckpt=d, resume=True)
    resumes = telemetry.events("resume")
    assert resumes and resumes[-1].attrs["stage"] == (
        stop_at.rstrip("!").split(":")[0])
    assert _gate_valid()
    np.testing.assert_array_equal(part, baseline)


def test_resume_skips_completed_levels(tmp_path, baseline):
    d = tmp_path / "ckpt"
    with pytest.raises(SimulatedPreemption):
        _run(ckpt=d, stop_at="dist-initial!")
    _, _, part = _run(ckpt=d, resume=True)
    assert [e for e in telemetry.events("checkpoint")
            if e.attrs.get("stage") == "dist-coarsen"] == []
    assert telemetry.events("resume")[-1].attrs["levels_restored"] >= 2
    np.testing.assert_array_equal(part, baseline)


def test_resume_under_another_shard_count_restarts_clean(tmp_path):
    d = tmp_path / "ckpt"
    with pytest.raises(SimulatedPreemption):
        _run(ckpt=d, stop_at="dist-coarsen:1!", n_devices=4)
    _, g, part = _run(ckpt=d, resume=True, n_devices=2)
    restarts = [e.attrs for e in telemetry.events("checkpoint")
                if e.attrs.get("action") == "clean-restart"]
    assert restarts and "shard fingerprints" in restarts[-1]["error"]
    assert not telemetry.events("resume")
    assert _gate_valid() and part.shape == (g.n,)


def test_checkpoint_meta_carries_the_shard_vector(tmp_path):
    d = tmp_path / "ckpt"
    with pytest.raises(SimulatedPreemption):
        _run(ckpt=d, stop_at="dist-uncoarsen:1!")
    man = json.load(open(d / "manifest.json"))
    assert man["scheme"] == "dist" and man["stage"] == "dist-uncoarsen"
    meta = man["meta"]
    assert len(meta["shards"]) == 4
    assert meta["num_levels"] >= 2 and meta["current_k"] >= 2
    snaps = set(man["snapshots"])
    assert any(s.startswith("dist-level-") for s in snaps)
    assert "state" in snaps


# -- the agreed ladder -----------------------------------------------------


def test_agree_max_and_agree_rung_adopt_the_fleet_maximum():
    agreement.set_gather_override(lambda row: np.stack([row, row + 1]))
    assert agreement.agree_max(1) == (2, 1)
    assert memory_mod.agree_rung(1) == (2, 1)
    agreement.set_gather_override(lambda row: np.stack([row, row + 2]))
    assert memory_mod.agree_rung(1) == (3, 1)
    agreement.set_gather_override(None)
    assert agreement.agree_max(5) == (5, 0)


@pytest.mark.parametrize("env", [
    {"KAMINPAR_TPU_FAULTS": "device-oom@rank=0:nth=1"},
    {"KAMINPAR_TPU_MEM_RUNG": "2"},
    {"KAMINPAR_TPU_MEM_RUNG": "3"},
], ids=["one-rank-oom", "rung-2", "rung-3-is-host-only"])
def test_dist_ladder_matches_jax(env):
    # the JAX host-only rung draws from the process-global seed, which its
    # dist facade never sets; the port's draws from the run's seed (1)
    from kaminpar_tpu.utils import rng as jrng

    jrng.set_seed(1)
    _, _, want = _run("jax", env=env)
    jdeg = [e.attrs for e in jtel.events("degraded")]
    _, g, got = _run("port", env=env)
    np.testing.assert_array_equal(got, want)
    deg = [e.attrs for e in telemetry.events("degraded")]
    assert [(e["site"], e["rung"], e.get("triggering_rank"))
            for e in deg] == [(e["site"], e["rung"],
                               e.get("triggering_rank")) for e in jdeg]
    st = memory_mod.state()
    assert _gate_valid() and got.shape == (g.n,)
    if "KAMINPAR_TPU_FAULTS" in env:
        assert deg[-1]["rung"] == 1 and deg[-1]["triggering_rank"] == 0
        assert st.rung == 1 and st.engaged
    elif env["KAMINPAR_TPU_MEM_RUNG"] == "2":
        assert telemetry.events("memory-spill")
        assert telemetry.events("memory-reload")
        assert st.spills >= 1 and st.reloads >= 1
    else:
        assert telemetry.events("host-only-partition")


def test_preflight_refuses_on_the_shard_estimate():
    from kaminpar_tpu_torch.resilience.runstate import current

    st = memory_mod.GovernorState()
    st.budget = 1
    current().memory = st
    try:
        with pytest.raises(DeviceOOM) as ei:
            memory_mod.preflight(1 << 16, 1 << 20, 8, where="dist")
        assert "preflight@dist" in str(ei.value)
    finally:
        current().memory = None


def test_shard_sizes_price_the_heaviest_shard():
    g = make_star(1 << 10)
    n_loc, m_loc, counts = shard_sizes(np.asarray(g.xadj), 4)
    assert sum(counts) == int(g.m)
    assert max(counts) > -(-int(g.m) // 4) and m_loc >= max(counts)


# -- rank-scoped faults ----------------------------------------------------


def test_rank_scoped_injection_fires_on_its_rank_only(monkeypatch):
    monkeypatch.setenv(resilience.FAULTS_ENV_VAR, "refiner@rank=1:nth=1")
    faults.maybe_inject("refiner")
    assert faults.injected_log() == []
    faults.reset()
    monkeypatch.setenv(agreement.ENV_SIM_RANK, "1")
    with pytest.raises(DeviceOOM) as ei:
        faults.maybe_inject("refiner")
    assert ei.value.injected
    assert faults.injected_log() == [{"site": "refiner", "call": 1,
                                      "rank": 1}]
    assert agreement.rank() == 1


def test_rank_scoped_fault_is_inert_on_rank_0(baseline):
    _, _, part = _run(env={resilience.FAULTS_ENV_VAR:
                           "device-oom@rank=1:nth=1"})
    assert telemetry.events("degraded") == []
    np.testing.assert_array_equal(part, baseline)


# -- divergence sentinels --------------------------------------------------


@pytest.mark.parametrize("skew,field", [([1, 0, 0], "stage"),
                                        ([0, 2, 0], "rung"),
                                        ([0, 0, 3], "fingerprint")])
def test_divergence_sentinel_fires_on_skew(skew, field):
    with pytest.raises(RankDivergence) as ei:
        _run(gather=lambda row: np.stack([row, row + np.array(skew)]))
    assert len(ei.value.ranks) == 2
    assert ei.value.site == "rank-divergence"
    assert telemetry.events("rank-divergence")[-1].attrs["fields"] == [
        field]
    sect = build_run_report()["dist_resilience"]
    assert sect["enabled"] and sect["divergence"]["fields"] == [field]


def test_divergence_sentinel_injected_site():
    with pytest.raises(RankDivergence) as ei:
        _run(env={resilience.FAULTS_ENV_VAR: "rank-divergence:nth=1"})
    assert ei.value.injected


def test_sentinel_audits_and_comm_account_in_the_report(baseline):
    _run()
    report = build_run_report()
    validate_report(report)
    sect = report["dist_resilience"]
    assert sect["enabled"] and sect["audits"] >= 4
    assert sect["ranks"] == 1 and sect["rank"] == 0
    assert len(sect["shard_fingerprints"]) == 4
    assert sect["ladder"] == {"agreed": True, "rung": 0}
    comm = report["comm"]
    assert comm["records"] and comm["bytes_total"] > 0
    assert {r["op"] for r in comm["records"]} >= {
        "all_to_all(halo)", "psum(weight-delta)", "all_gather(labels)"}
