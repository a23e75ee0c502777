"""The port's telemetry core: events, spans and the run report.

With telemetry enabled, a run of the port records the JAX package's events
on its path (`rating-engine`, `coarsening-level`, `extend-partition`,
`vcycle`, `rb-bisection`, `stream`, `output-gate`, `balancer-host-fallback`,
`fm-refused`) with the same attributes, times aside, in the same order.
(The external stream's upload bytes are the port's own, never more than
the JAX package's.)  Its run report validates against the port's schema
copy, has the JAX report's top-level keys, and its scope walls are
`last_timings`.  The report diff gives the JAX package's verdicts and
lines on the cases of tests/test_telemetry.py.  Disabled, telemetry
records nothing.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu import native as jax_native
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.context import PartitioningMode
from kaminpar_tpu.graphs.csr import device_graph_from_host as jax_upload
from kaminpar_tpu.partitioning.refiner import RefinerPipeline as JaxRefiner
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.telemetry import diff as jdiff
from kaminpar_tpu.telemetry.report import build_run_report as jax_report
from kaminpar_tpu_torch import native as port_native
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.graphs.csr import device_graph_from_host
from kaminpar_tpu_torch.partitioning.refiner import RefinerPipeline
from kaminpar_tpu_torch.telemetry import diff as tdiff
from kaminpar_tpu_torch.telemetry.report import (
    build_run_report,
    validate_report,
    write_run_report,
)
from kaminpar_tpu_torch.utils import timer
from test_torch_schemes import CASES, port_context
from torch_threads import one_torch_thread  # noqa: F401

PORT_EVENTS = {
    "rating-engine", "coarsening-level", "extend-partition", "vcycle",
    "rb-bisection", "stream", "output-gate", "balancer-host-fallback",
    "fm-refused",
}
# attributes that are wall-clock readings (or derived from them), and the
# stream's upload bytes: the port uploads only a batch's real edge slots,
# the JAX package its padded chunk (both are checked below)
TIME_ATTRS = {"decode_s", "drain_s", "overlap_frac", "uploaded_bytes"}


@pytest.fixture(autouse=True)
def _telemetry_off_afterwards():
    yield
    ttel.disable()
    jtel.disable()


def _events(module):
    return [
        (e.name, {k: v for k, v in e.attrs.items() if k not in TIME_ATTRS})
        for e in module.events() if e.name in PORT_EVENTS
    ]


def _rb(ctx):
    ctx.partitioning.mode = PartitioningMode.RB


def _external(ctx):
    ctx.partitioning.mode = PartitioningMode.EXTERNAL
    ctx.external.chunk_edges = 1 << 13


RUNS = {
    # run: (preset, configure, case)
    "deep": ("default", None, "rmat-k8"),
    "vcycle": ("vcycle", None, "rmat-k8"),
    "rb": ("default", _rb, "rgg-k4"),
    "external": ("default", _external, "rmat-k8"),
}


def _run_both(run):
    """(JAX partition, port partition, port solver) with telemetry on."""
    preset, configure, case = RUNS[run]
    make, k = CASES[case]
    host = make()
    jctx = jax_preset(preset)
    jctx.coarsening.contraction_limit = 160
    if configure is not None:
        configure(jctx)
    tctx = port_context(jctx)
    jtel.enable()
    jsolver = kt.KaMinPar(jctx)
    jsolver.set_output_level(0)
    jpart = np.asarray(jsolver.set_graph(host).compute_partition(
        k=k, epsilon=0.03, seed=1))
    ttel.enable()
    tsolver = kp.KaMinPar(tctx, device="cpu").set_graph(
        kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                     host.edge_weights))
    tsolver.set_output_level(0)
    tpart = tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    return jpart, tpart, tsolver


@pytest.mark.parametrize("run", sorted(RUNS))
def test_events_match_the_jax_package(run):
    jpart, tpart, _ = _run_both(run)
    np.testing.assert_array_equal(tpart, jpart)
    port, ref = _events(ttel), _events(jtel)
    assert port == ref
    uploads = [(e.attrs["uploaded_bytes"], j.attrs["uploaded_bytes"])
               for e, j in zip(ttel.events("stream"), jtel.events("stream"))]
    assert all(0 < mine <= theirs for mine, theirs in uploads)
    names = {name for name, _ in port}
    assert {"output-gate"} <= names
    assert {"deep": {"rating-engine", "coarsening-level", "extend-partition"},
            "vcycle": {"vcycle", "extend-partition"},
            "rb": {"rb-bisection"},
            "external": {"stream"}}[run] <= names


def test_report_validates_and_matches_the_jax_keys(tmp_path):
    jpart, tpart, tsolver = _run_both("deep")
    np.testing.assert_array_equal(tpart, jpart)
    path = tmp_path / "run.report.json"
    report = write_run_report(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(report))
    assert validate_report(report) == []
    assert set(report) == set(jax_report())
    assert report["result"] == tsolver.result_metrics(
        tsolver.graph(), tpart)
    assert report["output_gate"] == tsolver.last_gate
    assert report["run"]["preset"] == "default"
    assert report["environment"]["torch_version"] == torch.__version__
    assert "jax_version" not in report["environment"]
    assert report["levels"] and report["rating"]["engines"]
    walls = report["scope_tree"]["partitioning"]["children"]
    for phase, seconds in tsolver.last_timings.items():
        node = walls[phase.split("/")[0]]
        if "/" in phase:
            node = node["children"][phase.split("/")[1]]
        assert node["elapsed_s"] == round(seconds, 6), phase
    assert "lp-clustering" in walls["coarsening"]["children"]
    assert report["perf"]["kernels"].keys() == {
        "gather_i32", "dense_block_ratings", "best_from_slots",
        "scatter_best_from_slots"}
    # a report diffs clean against itself, in either package's diff
    for diff in (tdiff, jdiff):
        lines, failures = diff.diff_reports(report, report)
        assert failures == [] and lines
    # and a broken report fails the schema
    broken = dict(report, environment={"version": "x"})
    assert any("torch_version" in v for v in validate_report(broken))


def test_external_annotation_is_last_external():
    _, _, tsolver = _run_both("external")
    report = build_run_report()
    assert report["external"] == json.loads(
        json.dumps(tsolver.last_external))
    assert report["external"]["enabled"] and tsolver.last_external[
        "streamed_levels"] == len(ttel.events("stream"))
    assert validate_report(report) == []


def test_balancer_host_fallback_and_fm_refused_events():
    """Forced where the main path never reaches them: an overloaded
    partition handed to the exact host balancer, and the native FM asked
    for a k beyond its sparse engine's tags."""
    make, k = CASES["rgg-k4"]
    host = make()
    jctx = jax_preset("default")
    jctx.partition.setup(host, k=k, epsilon=0.03)
    tctx = port_context(jctx)
    tctx.partition.setup(host, k=k, epsilon=0.03)
    part = np.zeros(host.n, dtype=np.int32)
    part[: host.n // 8] = 1  # blocks 2, 3 empty, block 0 overloaded
    caps = np.asarray(jctx.partition.max_block_weights)
    jtel.enable()
    jtel.reset()
    jg = jax_upload(host)
    padded = np.zeros(jg.n_pad, dtype=np.int32)
    padded[: host.n] = part
    jout = JaxRefiner(jctx, k).enforce_balance_host(
        jg, jnp.asarray(padded), caps, where="deep")
    ttel.enable()
    ttel.reset()
    tgraph = kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                          host.edge_weights)
    tg = device_graph_from_host(tgraph, torch.device("cpu"))
    tout = RefinerPipeline(tctx, k).enforce_balance_host(
        tg, torch.from_numpy(padded), caps, where="deep")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    fm_ctx = jctx.refinement.fm
    for module, call in ((jtel, jax_native.fm_refine),
                         (ttel, port_native.fm_refine)):
        p = part.copy()
        call(host if module is jtel else tgraph, p, 70_000,
             np.full(70_000, host.n, dtype=np.int64), fm_ctx, 1,
             force_sparse=True)
    assert _events(ttel) == _events(jtel)
    assert [name for name, _ in _events(ttel)] == [
        "balancer-host-fallback", "fm-refused"]


def test_disabled_records_nothing():
    ttel.disable()
    ttel.reset()
    tgraph = kp.make_rmat(1 << 10, 4000, seed=3)
    solver = kp.KaMinPar("default", device="cpu").set_graph(tgraph)
    solver.ctx.coarsening.contraction_limit = 160
    solver.set_output_level(0)
    solver.compute_partition(k=4, epsilon=0.03, seed=1)
    assert ttel.events() == [] and ttel.spans() == []
    assert ttel.run_info() == {} and ttel.gate_verdict() is None
    # the timer still keeps its tree, which last_timings is read from
    assert timer.GLOBAL_TIMER.elapsed("partitioning") > 0
    ttel.enable()
    solver.compute_partition(k=4, epsilon=0.03, seed=1)
    assert ttel.gate_verdict() is True
    paths = {s.path for s in ttel.spans()}
    assert {"partitioning", "partitioning.coarsening",
            "partitioning.coarsening.lp-clustering", "output-gate"} <= paths


def test_cli_helpers_write_and_diff_the_report(tmp_path, capsys):
    """--report-json enables telemetry and writes the report after the
    run; --diff-base diffs it against a baseline (itself: exit 0)."""
    import argparse

    parser = argparse.ArgumentParser()
    ttel.add_cli_args(parser)
    path = str(tmp_path / "r.json")
    args = parser.parse_args(["--report-json", path])
    ttel.disable()
    ttel.enable_if_requested(args)
    assert ttel.enabled()
    solver = kp.KaMinPar("default", device="cpu").set_graph(
        kp.make_rmat(1 << 9, 2000, seed=1))
    solver.set_output_level(0)
    solver.compute_partition(k=2, epsilon=0.03, seed=1)
    assert ttel.export_cli_outputs(args, extra_run={"wall_seconds": 1.0},
                                   quiet=True) == 0
    report = json.loads(open(path).read())
    assert validate_report(report) == []
    assert report["run"]["wall_seconds"] == 1.0
    args = parser.parse_args(["--report-json", path, "--diff-base", path])
    assert ttel.export_cli_outputs(args, quiet=True) == 0
    assert "DIFF OK" in capsys.readouterr().out
    args = parser.parse_args(["--diff-base", path])
    assert ttel.export_cli_outputs(args) == 2


def test_progress_series_reach_the_report():
    ttel.enable()
    ttel.reset()
    with timer.scoped_timer("uncoarsening"):
        ttel.record_progress("jet", {"cut": [120, 100], "moved": [5, 0]}, 2,
                             level=0, round=1)
    ttel.record_progress("lp", {"moved": [3]}, 1)
    assert [p.kind for p in ttel.progress_series()] == ["jet", "lp"]
    (jet,) = ttel.progress_series("jet")
    assert jet.path == "uncoarsening" and jet.attrs == {"level": 0,
                                                        "round": 1}
    report = build_run_report()
    assert report["progress"][0]["series"]["cut"] == [120, 100]
    # no partition ran in this stream: only the result section is empty
    assert all(v.startswith("$.result:") for v in validate_report(report))


def test_timer_tree_and_aggregation():
    t = timer.Timer()
    with timer.scoped_timer("a", timer=t) as outer:
        with timer.scoped_timer("b", timer=t, sync=torch.device("cpu")):
            pass
        assert t.current_path() == "a" and not t.idle()
    with timer.scoped_timer("a", timer=t):
        pass
    assert t.idle() and t.root.children["a"].count == 2
    assert outer.elapsed > 0 and t.elapsed("a", "b") > 0
    agg = timer.aggregate_across_processes(t)
    assert set(agg) == {"a", "a.b"} and agg["a"]["count"] == 2
    assert agg["a.b"]["min"] == agg["a.b"]["max"] == t.elapsed("a", "b")
    lines = timer.render_aggregated(agg).splitlines()
    assert lines[0].startswith("  a: min=") and lines[0].endswith("(2x)")
    assert lines[1].startswith("    b: min=")


# ---------------------------------------------------------------------------
# the report diff: the cases of tests/test_telemetry.py, in both packages
# ---------------------------------------------------------------------------


def _reference_report(cut=100, wall=10.0):
    return {
        "schema_version": 2,
        "run": {"partition_seconds": wall},
        "result": {"cut": cut, "imbalance": 0.0, "feasible": True},
        "scope_tree": {
            "partitioning": {
                "elapsed_s": wall, "count": 1,
                "children": {
                    "coarsening": {
                        "elapsed_s": wall / 2, "count": 1, "children": {}
                    }
                },
            }
        },
        "progress": [
            {"kind": "jet", "path": "partitioning.jet", "t0": 0.0,
             "t1": 1.0, "iterations": 3,
             "series": {"cut": [120, 110, cut], "moved": [5, 3, 0]},
             "attrs": {"round": 0}},
        ],
        "compile": {"caveat": "c", "totals": {"compile_s": 1.0,
                                              "compiles": 3},
                    "phases": {}},
    }


def _infeasible():
    r = _reference_report()
    r["result"]["feasible"] = False
    return r


def _slower_progress():
    r = _reference_report()
    r["progress"][0]["iterations"] = 2
    r["progress"][0]["series"]["cut"] = [120, 100]
    r["progress"][0]["series"]["moved"] = [5, 0]
    return r


DIFF_CASES = {
    # case: (base, cand, extra args, exit code)
    "identical": (_reference_report(), _reference_report(), [], 0),
    "cut": (_reference_report(), _reference_report(cut=120), [], 1),
    "wall": (_reference_report(), _reference_report(wall=12.0), [], 1),
    "cut, raised threshold": (_reference_report(),
                              _reference_report(cut=120),
                              ["--cut-threshold", "0.5"], 0),
    "wall, raised threshold": (_reference_report(),
                               _reference_report(wall=12.0),
                               ["--wall-threshold", "0.5"], 0),
    "infeasible, json": (_reference_report(), _infeasible(), ["--json"], 1),
    "progress": (_reference_report(), _slower_progress(), [], 0),
    "junk": ({}, _reference_report(), [], 2),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_main_matches_the_jax_package(tmp_path, capsys, case):
    base, cand, extra, code = DIFF_CASES[case]
    a, b = tmp_path / "base.json", tmp_path / "cand.json"
    a.write_text(json.dumps(base))
    b.write_text(json.dumps(cand))
    outputs = []
    for module in (tdiff, jdiff):
        assert module.main([str(a), str(b), *extra]) == code
        outputs.append(capsys.readouterr())
    assert outputs[0] == outputs[1]
    if case == "progress":
        assert "iters 3 -> 2" in outputs[0].out
    if code == 1 and "--json" not in extra:
        assert "REGRESSION" in outputs[0].err
    if case == "infeasible, json":
        verdict = json.loads(outputs[0].out.strip())
        assert verdict["pass"] is False
        assert any("feasibility" in f for f in verdict["failures"])


def test_diff_missing_file_is_usage_error(tmp_path):
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(_reference_report()))
    assert tdiff.main([str(tmp_path / "missing.json"), str(ok)]) == 2


def _serving(served, total, hit_rate):
    return {"serving": {
        "enabled": True,
        "counts": {"served": served, "failed": total - served},
        "cache": {"hit_rate": hit_rate},
        "requests": [{"request_id": f"r{i}",
                      "verdict": "served" if i < served else "failed"}
                     for i in range(total)],
    }}


def _quality(locked, verdict):
    return {"quality": {
        "enabled": True,
        "totals": {"gap_mass": 10, "coarsening_locked_frac": 0.5,
                   "refinement_left_frac": 0.5},
        "levels": [{"level": 0, "coarsening_locked": locked,
                    "refinement_left": 3, "verdict": verdict}],
    }}


@pytest.mark.parametrize("base,cand", [
    (_serving(12, 12, 0.9), _serving(16, 16, 0.9)),
    (_serving(16, 16, 0.9), _serving(12, 16, 0.5)),
    (_serving(16, 16, 0.9), {"serving": {"enabled": False}}),
])
def test_diff_serving_matches(base, cand):
    assert tdiff.diff_serving(base, cand) == jdiff.diff_serving(base, cand)


@pytest.mark.parametrize("base,cand", [
    (_quality(4, "ok"), _quality(6, "stalled")),
    ({}, _quality(4, "ok")),
])
def test_diff_quality_matches(base, cand):
    assert tdiff.diff_quality(base, cand) == jdiff.diff_quality(base, cand)
