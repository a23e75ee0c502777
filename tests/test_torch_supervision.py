"""The port's supervisor (kaminpar_tpu_torch/resilience/supervisor.py)
against the JAX package's, on the CPU: `hard_ceiling` over a grid of
budgets, graces, factors and environment values; the `watchdog-armed`
event; the watchdog turning a Python-level overrun into a StageHang; a
guard without a ceiling arming nothing; `with_fallback` never swallowing
a watchdog verdict; the heartbeat advancing across barriers; the facade
arming the watchdog from `hard_deadline_factor`; a worker that cannot
reach the card failing instead of running on the CPU; and a
process-isolated service whose worker gives the JAX package's in-process
partitions, is SIGKILLed on an injected hang (failed/worker-hang) and is
replaced for the next request.  Two workers are spawned.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs.factories import make_rgg2d
from kaminpar_tpu.resilience import deadline as jdeadline
from kaminpar_tpu.resilience import supervisor as jsup
from kaminpar_tpu.serving import PartitionRequest as JReq
from kaminpar_tpu.serving import PartitionService as JService
from kaminpar_tpu.serving import ServiceConfig as JConfig
import kaminpar_tpu_torch as tkp
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.resilience import StageHang
from kaminpar_tpu_torch.resilience import deadline as tdeadline
from kaminpar_tpu_torch.resilience import supervisor as tsup
from kaminpar_tpu_torch.serving import PartitionRequest as TReq
from kaminpar_tpu_torch.serving import PartitionService as TService
from kaminpar_tpu_torch.serving import ServiceConfig as TConfig
from kaminpar_tpu_torch.telemetry.report import (
    build_run_report,
    validate_report,
)
from kaminpar_tpu_torch.utils import timer as ttimer
from torch_threads import one_torch_thread  # noqa: F401

SPEC = "gen:rgg2d;n=600;avg_degree=8;seed=1"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("KAMINPAR_TPU_FAULTS", tsup.ENV_HARD_DEADLINE_S,
                tsup.ENV_HEARTBEAT_FILE):
        monkeypatch.delenv(var, raising=False)
    for mod in (jres, tres, jtel, ttel):
        mod.reset()
    yield
    for mod in (jtel, ttel):
        mod.disable()
    for mod in (jres, tres, jtel, ttel):
        mod.reset()


@pytest.mark.parametrize("env", [None, "7.5", "0", "-1", "junk"])
def test_hard_ceiling_is_the_jax_supervisors(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv(tsup.ENV_HARD_DEADLINE_S, env)
    grid = [(b, g, f) for b in (None, 0.0, 0.05, 1.0, 100.0)
            for g in (None, 0.0, 30.0) for f in (None, 0.0, 2.0, 10.0)]
    for budget, grace, factor in grid:
        assert tsup.hard_ceiling(budget, grace, factor) == \
            jsup.hard_ceiling(budget, grace, factor), (budget, grace, factor)
    assert tsup.env_ceiling() == jsup.env_ceiling()


@pytest.mark.parametrize("budget,grace,factor", [
    (1.0, None, None), (1.0, 30.0, 0.0), (100.0, 30.0, 2.0), (None, None,
                                                              None)])
def test_watchdog_armed_event_is_the_jax_packages(budget, grace, factor):
    for tel, deadline in ((jtel, jdeadline), (ttel, tdeadline)):
        tel.reset()
        tel.enable()
        deadline.begin_run(budget, grace, factor)
    rows = [[(e.name, e.attrs) for e in tel.events("watchdog-armed")]
            for tel in (jtel, ttel)]
    assert rows[1] == rows[0]
    assert bool(rows[1]) == (budget is not None and factor != 0.0)


def test_watchdog_converts_overrun_to_stage_hang():
    """An armed stage past its ceiling gets a StageHang at the next
    bytecode boundary, with the stage, ceiling and stuck scope path."""
    ttel.enable()
    caught = {}

    def victim():
        try:
            with ttimer.scoped_timer("victim-phase"):
                with tsup.stage_guard("unit-stage", 0.3):
                    t0 = time.time()
                    while time.time() - t0 < 8.0:
                        time.sleep(0.01)
        except StageHang as e:
            caught["exc"] = e

    t = threading.Thread(target=victim)
    t.start()
    t.join(12.0)
    exc = caught.get("exc")
    assert exc is not None, "the watchdog never fired"
    assert (exc.stage, exc.ceiling_s) == ("unit-stage", 0.3)
    hangs = tsup.hang_log()
    assert hangs and hangs[-1]["stage"] == "unit-stage"
    assert "victim-phase" in hangs[-1]["path"]
    assert tsup.watchdog_stats()["fired"] >= 1
    assert ttel.events("stage-hang")


def test_stage_guard_without_ceiling_is_a_noop():
    before = tsup.watchdog_stats()["armed"]
    for ceiling in (None, 0.0):
        with tsup.stage_guard("noop", ceiling):
            pass
    assert tsup.watchdog_stats()["armed"] == before
    assert tsup.summary() == jsup.summary() == {"enabled": False}


def test_with_fallback_never_swallows_a_watchdog_verdict():
    def primary():
        raise StageHang("delivered mid-primary")

    with pytest.raises(StageHang):
        tres.with_fallback(primary, lambda exc: "swallowed", site="refiner")
    # an injected StageHang (the worker-hang chaos site) falls back
    got = tres.with_fallback(
        lambda: (_ for _ in ()).throw(StageHang("x", injected=True)),
        lambda exc: "fell-back", site="worker-hang")
    assert got == "fell-back"


def test_heartbeat_mtime_advances_across_barriers(tmp_path):
    hb = tmp_path / "heartbeat"
    tsup.set_heartbeat(str(hb))
    assert hb.exists()
    m0 = hb.stat().st_mtime_ns
    count0 = tsup.heartbeat_state()["count"]
    g = make_rgg2d(256, avg_degree=8, seed=1)
    solver = tkp.KaMinPar("default", device="cpu")
    solver.set_output_level(0)
    part = solver.set_graph(HostGraph(g.xadj, g.adjncy)).compute_partition(
        k=2, epsilon=0.05, seed=1)
    assert len(part) == g.n
    assert tsup.heartbeat_state()["count"] > count0
    assert hb.stat().st_mtime_ns > m0
    assert tsup.summary()["heartbeat"] == {
        "file": str(hb), "count": tsup.heartbeat_state()["count"]}


def test_the_facade_arms_the_watchdog_from_the_factor():
    """A budgeted run arms a stage at max(factor * budget, budget +
    grace); factor 0 arms none.  The run report's supervision section
    says so and validates."""
    g = make_rgg2d(256, avg_degree=8, seed=1)
    ttel.enable()
    for factor, armed in ((10.0, 1), (0.0, 0)):
        tsup.reset()
        solver = tkp.KaMinPar("default", device="cpu")
        solver.set_output_level(0)
        solver.ctx.resilience.time_budget = 60.0
        solver.ctx.resilience.hard_deadline_factor = factor
        solver.set_graph(HostGraph(g.xadj, g.adjncy)).compute_partition(
            k=2, epsilon=0.05, seed=1)
        assert tsup.watchdog_stats() == {"armed": armed, "fired": 0}
        report = build_run_report()
        assert validate_report(report) == []
        assert report["supervision"]["enabled"] == bool(armed)


def test_a_worker_never_computes_on_the_cpu_in_place_of_the_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TService("default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsup._worker_compute({"device": "cuda", "ctx": {},
                              "graph": {"kind": "source", "value": SPEC}},
                             lambda msg: None)


def test_injected_hang_without_a_ceiling_fails_fast(monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "worker-hang:nth=1")
    pool = tsup.WorkerPool(device="cpu")
    try:
        with pytest.raises(StageHang) as ei:
            pool.run_request("fast-fail", SPEC, None, None, k=4,
                             epsilon=0.03, seed=1, ceiling_s=None)
        assert ei.value.injected and pool.stats["spawned"] == 0
    finally:
        pool.shutdown()


def test_process_isolated_service_is_the_jax_inproc_service(monkeypatch):
    g = make_rgg2d(600, avg_degree=8, seed=3)
    jsvc = JService("default", JConfig(keep_partitions=True))
    jrecs = {r.request_id: r for r in jsvc.serve([
        JReq(SPEC, k=4, seed=1, request_id="a"),
        JReq(g, k=4, seed=2, request_id="c")])}
    jres.reset()

    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "worker-hang:nth=2")
    svc = TService("default", TConfig(isolation="process",
                                      keep_partitions=True), device="cpu")
    try:
        recs = svc.serve([
            TReq(SPEC, k=4, seed=1, request_id="a"),
            TReq(SPEC, k=4, seed=5, hard_deadline_s=1.0, request_id="b"),
            TReq(HostGraph(g.xadj, g.adjncy, g.node_weights,
                           g.edge_weights), k=4, seed=2, request_id="c"),
        ])
        by_id = {r.request_id: r for r in recs}
        for rid in ("a", "c"):
            assert by_id[rid].verdict == "served"
            np.testing.assert_array_equal(by_id[rid].partition,
                                          jrecs[rid].partition)
            assert by_id[rid].cut == jrecs[rid].cut
            # the worker's ledger rides on the record: every kernel named,
            # none launched on the CPU, and untimed (no EVENT_LOG here)
            assert by_id[rid].worker_launches == {
                "gather_i32": 0, "dense_block_ratings": 0,
                "best_from_slots": 0, "scatter_best_from_slots": 0}
            assert by_id[rid].worker_kernel_ms is None
            assert by_id[rid].device_peak_bytes is None
        b = by_id["b"]
        assert (b.verdict, b.reason, b.error) == (
            "failed", "worker-hang", "StageHang")
        assert b.hard_ceiling_s == 1.0
        sup = svc.supervision_summary()
        assert set(sup) == {"enabled", "isolation", "workers", "hangs",
                            "heartbeat", "watchdog"}
        assert sup["isolation"] == "process"
        assert sup["workers"] == {"spawned": 2, "recycled": 0, "killed": 1,
                                  "crashed": 0, "requests": 3}
        assert sup["hangs"][0]["request"] == "b"
        assert svc.summary()["counts"]["worker-hang"] == 1
        # the worker ran on the service's device with the parent's threads
        assert svc._pool._worker.threads == torch.get_num_threads()
        pool = svc._pool
        assert len(pool.spawn_seconds) == len(pool.spawn_rss_bytes) == 2
        assert len(pool.ship_seconds) == 1 and len(pool.rss_bytes) == 2
        # a bounded window of readings, not one entry per request forever
        assert pool.rss_bytes.maxlen == tsup.RECENT_READINGS
        # the workers' own RSS, not the parent's (which ru_maxrss would
        # carry across the spawn's exec): this process holds JAX too
        import resource

        parent = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        assert all(0 < b < parent
                   for b in pool.spawn_rss_bytes + pool.rss_bytes)
        # the shipped graph was spool scratch, removed after its request
        assert not [f for f in os.listdir(svc._pool._spool)
                    if f.endswith("-graph.npz")]
    finally:
        svc.close()
