"""The port's command line against the JAX package's: `--dump-config`
gives the same TOML for every preset (and the two trees the same
checkpoint fingerprint) and each package's dump loads in the other's
`-C`; the partition, block-size and remapping files are bitwise
the JAX CLI's (with a config file, a refinement override, `-B`,
`--min-epsilon` and `--node-ordering degree-buckets`); `--machine-timers`
prints the deep scheme's phases; `--delta-batch` writes the JAX chain's
final partition; each serving, heartbeat, metrics and trace flag and
variable gives the JAX CLI's records and files; and without a card the
default `--device cuda` fails.

Both CLIs run in this process on `gen:` graphs, the port's with
`--device cpu`.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import kaminpar_tpu.dynamic as jdyn
from kaminpar_tpu import cli as jcli
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.context import context_to_dict as jax_context_to_dict
from kaminpar_tpu.graphs.factories import generate as jax_generate
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.resilience.checkpoint import (
    ctx_fingerprint as jax_ctx_fingerprint,
)
from kaminpar_tpu.telemetry import metrics as jmetrics
from kaminpar_tpu.telemetry import tracing as jtracing
from kaminpar_tpu.utils import heap_profiler as jheap
from kaminpar_tpu.utils import statistics as jstats
from kaminpar_tpu_torch import cli as tcli
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.context import context_to_dict
from kaminpar_tpu_torch.presets import (
    create_context_by_preset_name,
    get_preset_names,
)
from kaminpar_tpu_torch.resilience.checkpoint import (
    ctx_fingerprint as port_ctx_fingerprint,
)
from kaminpar_tpu_torch.telemetry import metrics as tmetrics
from kaminpar_tpu_torch.telemetry import tracing as ttracing
from kaminpar_tpu_torch.telemetry.report import validate_report
from kaminpar_tpu_torch.utils import timer as ttimer
from kaminpar_tpu_torch.utils import heap_profiler as theap
from kaminpar_tpu_torch.utils import statistics as tstats
from torch_threads import one_torch_thread  # noqa: F401

GRAPH = "gen:rmat;n=2048;m=12000;seed=3"
N = 2048
CHAIN_GRAPH = "gen:rgg2d;n=1024;avg_degree=8.0;seed=3"
PRESETS = sorted(get_preset_names())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both CLIs install signal handlers and switch global recorders on;
    each test starts and ends with them restored."""
    for var in ("KAMINPAR_TPU_FAULTS", "KAMINPAR_TPU_STOP_AT",
                "KAMINPAR_TPU_METRICS_FILE", "KAMINPAR_TPU_HEARTBEAT_FILE"):
        monkeypatch.delenv(var, raising=False)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    # live metrics and request traces are process-wide stores that other
    # test files may leave filled
    for mod in (jmetrics, tmetrics):
        mod.reset()
    for mod in (jtracing, ttracing):
        mod.reset_traces()
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    for mod in (jstats, tstats, jheap, theap, jtel, ttel):
        mod.disable()
    for mod in (jres, tres, jtel, ttel, jmetrics, tmetrics):
        mod.reset()
    for mod in (jtracing, ttracing):
        mod.reset_traces()


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---------------------------------------------------------------------------
# config round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_dump_config_is_the_jax_toml(preset, capsys):
    argv = ["-P", preset, "--dump-config"]
    jrc, jout, _ = run(jcli.main, argv, capsys)
    trc, tout, _ = run(tcli.main, argv, capsys)
    assert jrc == trc == 0
    assert tout == jout and "[dynamic]" in tout and "[debug]" in tout
    # the checkpoint identity of the two trees is one value
    assert port_ctx_fingerprint(create_context_by_preset_name(
        preset)) == jax_ctx_fingerprint(jax_preset(preset))


@pytest.mark.parametrize("preset", PRESETS)
def test_each_dump_loads_in_the_other_cli(preset, tmp_path, capsys):
    argv = ["-P", preset, "--dump-config"]
    jax_toml = tmp_path / "jax.toml"
    jax_toml.write_text(run(jcli.main, argv, capsys)[1])
    port_toml = tmp_path / "port.toml"
    port_toml.write_text(run(tcli.main, argv, capsys)[1])
    # the other package's file, over a preset that differs from it
    other = "strong" if preset != "strong" else "fast"
    jctx = jcli.make_context(jcli.build_parser().parse_args(
        ["g", "-P", other, "-C", str(port_toml)]))
    tctx = tcli.make_context(tcli.build_parser().parse_args(
        ["g", "-P", other, "-C", str(jax_toml)]))
    assert context_to_dict(tctx) == jax_context_to_dict(jctx)
    # a dump holds every field: loaded over another preset, it is its own
    assert context_to_dict(tctx) == context_to_dict(
        create_context_by_preset_name(preset))


def test_unknown_config_key_is_refused(tmp_path):
    cfg = tmp_path / "bad.toml"
    cfg.write_text("[coarsening]\nno_such_knob = 1\n")
    for cli in (jcli, tcli):
        with pytest.raises(ValueError, match="no_such_knob"):
            cli.make_context(cli.build_parser().parse_args(
                ["g", "-C", str(cfg)]))


# ---------------------------------------------------------------------------
# partitions and output files
# ---------------------------------------------------------------------------


def outputs(main, tmp_path, tag, argv, capsys):
    files = {what: tmp_path / f"{tag}.{what}"
             for what in ("part", "sizes", "remap")}
    rc, out, err = run(main, argv + [
        "-o", str(files["part"]), "--output-block-sizes",
        str(files["sizes"]), "--output-remapping", str(files["remap"])],
        capsys)
    assert rc == 0, err
    return {k: v.read_bytes() for k, v in files.items()}, out, err


@pytest.mark.parametrize("case", ["config+refinement", "degree-buckets",
                                  "block-weights"])
def test_output_files_are_the_jax_clis(case, tmp_path, capsys):
    cfg = tmp_path / "cfg.toml"
    cfg.write_text("seed = 7\n[coarsening]\ncontraction_limit = 160\n")
    # every case overrides the refiners (Jet off keeps the JAX compiles
    # of this file few) and sets minimum block weights
    argv = [GRAPH, "-C", str(cfg), "-e", "0.03", "--machine-timers",
            "--refinement", "overload-balancer;lp;underload-balancer",
            "--min-epsilon", "0.2"]
    if case == "config+refinement":
        argv += ["-k", "8", "--debug-dump", "toplevel-graph",
                 "toplevel-partition", "coarsest-graph",
                 "coarsest-partition"]
    elif case == "degree-buckets":
        argv += ["-k", "8", "-s", "1", "--node-ordering", "degree-buckets"]
    else:
        argv += ["-B", *(["260"] * 8), "-s", "1"]
    jfiles, jout, _ = outputs(
        jcli.main, tmp_path, "jax",
        argv + ["--debug-dump-dir", str(tmp_path / "jax-dumps")], capsys)
    tfiles, tout, terr = outputs(
        tcli.main, tmp_path, "port",
        argv + ["--device", "cpu",
                "--debug-dump-dir", str(tmp_path / "port-dumps")], capsys)
    assert tfiles == jfiles
    if case == "config+refinement":
        # the dumps are named after the input (the gen: spec here)
        jdumps = sorted((tmp_path / "jax-dumps").iterdir())
        tdumps = sorted((tmp_path / "port-dumps").iterdir())
        assert [p.name for p in tdumps] == [p.name for p in jdumps]
        assert len(tdumps) == 4
        assert [p.read_bytes() for p in tdumps] == [
            p.read_bytes() for p in jdumps]
    part = np.loadtxt(tmp_path / "port.part", dtype=np.int64)
    assert part.shape == (N,) and part.max() == 7
    remap = np.loadtxt(tmp_path / "port.remap", dtype=np.int64)
    if case == "degree-buckets":
        # file order: the remapping is the permutation, not the identity
        assert sorted(remap) == list(range(N))
        assert not np.array_equal(remap, np.arange(N))
    else:
        assert np.array_equal(remap, np.arange(N))
    if case == "block-weights":
        sizes = np.loadtxt(tmp_path / "port.sizes", dtype=np.int64)
        assert sizes.max() <= 260
    # the RESULT line (the facade's logger) and the machine timers
    result = [ln for ln in terr.splitlines() if "RESULT" in ln]
    assert len(result) == 1
    timers = [ln for ln in tout.splitlines() if ln.startswith("TIMERS ")]
    jtimers = [ln for ln in jout.splitlines() if ln.startswith("TIMERS ")]
    assert len(timers) == len(jtimers) == 1
    keys = {kv.split("=")[0] for kv in timers[0].split()[1:]}
    jkeys = {kv.split("=")[0] for kv in jtimers[0].split()[1:]}
    phases = {"partitioning", "output-gate", "partitioning.coarsening",
              "partitioning.initial-partitioning",
              "partitioning.uncoarsening"}
    assert phases <= keys & jkeys
    assert all(float(kv.split("=")[1]) >= 0 for kv in timers[0].split()[1:])
    assert any(ln.startswith("TIME io=") for ln in tout.splitlines())


def test_delta_batch_writes_the_jax_chain(tmp_path, capsys):
    graph = jax_generate(CHAIN_GRAPH)
    batches = jdyn.synth_chain(graph, steps=2, seed=41, edge_churn=0.01,
                               vertex_adds_every=2)
    deltas = tmp_path / "deltas.json"
    deltas.write_text(json.dumps([b.to_dict() for b in batches]))
    argv = [CHAIN_GRAPH, "-k", "4", "-e", "0.03", "-s", "1",
            "--delta-batch", str(deltas)]
    jrc, jout, _ = run(jcli.main, argv + [
        "-o", str(tmp_path / "jax.part"),
        "--report-json", str(tmp_path / "jax.report.json")], capsys)
    trc, tout, terr = run(tcli.main, argv + [
        "-o", str(tmp_path / "port.part"), "--device", "cpu",
        "--report-json", str(tmp_path / "port.report.json")], capsys)
    assert jrc == trc == 0, terr
    assert (tmp_path / "port.part").read_bytes() == (
        tmp_path / "jax.part").read_bytes()

    def dynamic_lines(out):
        # the walls differ; the rest of each DYNAMIC line must not
        return [" ".join(w for w in ln.split() if not w.startswith("wall="))
                for ln in out.splitlines() if ln.startswith("DYNAMIC")]

    assert dynamic_lines(tout) == dynamic_lines(jout)
    assert len(dynamic_lines(tout)) == 4  # register, 2 steps, the chain
    report = json.loads((tmp_path / "port.report.json").read_text())
    assert validate_report(report) == []
    assert report["dynamic"]["enabled"]
    assert report["dynamic"]["counts"]["deltas"] == 2
    assert report["run"]["delta_steps"] == 2


@pytest.mark.parametrize("argv", [
    ["-k", "4", "--node-ordering", "degree-buckets"],
    ["-k", "4", "--output-remapping", "x"],
    ["-B", "600", "600"],
])
def test_delta_batch_refusals_are_the_jax_clis(argv, tmp_path, capsys):
    deltas = tmp_path / "deltas.json"
    deltas.write_text(json.dumps([{"edge_inserts": [[0, 5]]}]))
    full = [CHAIN_GRAPH, "--delta-batch", str(deltas)] + argv
    jrc, _, jerr = run(jcli.main, full, capsys)
    trc, _, terr = run(tcli.main, full + ["--device", "cpu"], capsys)
    assert jrc == trc == 2 and terr == jerr


# ---------------------------------------------------------------------------
# serving, heartbeat, live metrics and Chrome traces; the device rule
# ---------------------------------------------------------------------------


def serve_setup(tmp_path, traced):
    """A batch spec (a request, its duplicate, a k=0 request) and the
    base flags, chosen so the JAX compiles of this file are shared: the
    output-file cases' graph, config and refiners, or, for a run with
    telemetry on, the delta-batch case's graph and k."""
    graph, k, base = CHAIN_GRAPH, 4, []
    if not traced:
        cfg = tmp_path / "cfg.toml"
        cfg.write_text("seed = 7\n[coarsening]\ncontraction_limit = 160\n")
        graph, k = GRAPH, 8
        base = ["-C", str(cfg), "--refinement",
                "overload-balancer;lp;underload-balancer"]
    batch = tmp_path / "batch.json"
    batch.write_text(json.dumps({"requests": [
        {"graph": graph, "k": k, "seed": 1, "id": "a"},
        {"graph": graph, "k": k, "seed": 1, "id": "a-again"},
        {"graph": graph, "k": 0, "id": "k0"}]}))
    return str(batch), base


def served_lines(out):
    """The SERVED records of a batch, their walls left out."""
    return [" ".join(t for t in ln.split() if not t.startswith("wall="))
            for ln in out.splitlines() if ln.startswith("SERVED ")]


def metric_names(path):
    return {ln.split()[2] for ln in open(path).read().splitlines()
            if ln.startswith("# TYPE ")}


def trace_tracks(path):
    data = json.loads(open(path).read())
    return {(e["pid"], e["tid"], e["args"]["name"])
            for e in data["traceEvents"] if e["ph"] == "M"}


SERVING_CASES = [
    ("--serve-batch", None), ("--serve-queue-depth", "1"),
    ("--serve-cost-cap", "1000"), ("--serve-isolation", "process"),
    ("--heartbeat-file", "{out}.hb"), ("--metrics-file", "{out}.prom"),
    ("--trace-out", "{out}.trace.json"),
    ("KAMINPAR_TPU_HEARTBEAT_FILE", "{out}.hb"),
    ("KAMINPAR_TPU_METRICS_FILE", "{out}.prom"),
]


@pytest.mark.parametrize("flag,value", SERVING_CASES)
def test_serving_flags_and_variables_are_the_jax_clis(flag, value,
                                                      tmp_path, capsys,
                                                      monkeypatch):
    """Each flag (or variable) of the serving layer, the supervisor's
    heartbeat, the live metrics and the Chrome trace runs a batch in both
    CLIs: the same SERVED records, and files with the same heartbeat,
    metric names and trace tracks.  `--serve-isolation process` serves
    the port's batch in a spawned worker and the JAX CLI's in process."""
    batch, base = serve_setup(tmp_path, traced=flag == "--trace-out")
    got = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        out = str(tmp_path / pkg)
        argv = ["--serve-batch", batch] + base
        val = value.format(out=out) if value else None
        if flag.startswith("KAMINPAR_TPU_"):
            monkeypatch.setenv(flag, val)
        elif flag == "--serve-isolation" and pkg == "jax":
            argv += [flag, "inproc"]
        elif flag != "--serve-batch":
            argv += [flag, val]
        if pkg == "port":
            argv += ["--device", "cpu"]
        rc, stdout, _ = run(main, argv, capsys)
        assert rc == 0, (pkg, stdout)
        got[pkg] = (served_lines(stdout), val)
        for mod in (jres, tres, jtel, ttel, jmetrics, tmetrics):
            mod.reset()
    assert got["port"][0] == got["jax"][0]
    rows = got["port"][0]
    if flag == "--serve-cost-cap":
        assert all("reason=" in r for r in rows)
    else:
        assert any("cache=hit" in r for r in rows)
    assert any("reason=invalid-parameters" in r for r in rows)
    jpath, tpath = got["jax"][1], got["port"][1]
    if flag.endswith(("HEARTBEAT_FILE", "heartbeat-file")):
        assert os.path.exists(jpath) and os.path.exists(tpath)
    elif flag.endswith(("METRICS_FILE", "metrics-file")):
        names = metric_names(tpath)
        assert names == metric_names(jpath)
        assert {"kmp_requests_total", "kmp_cache_hit_rate"} <= names
    elif flag == "--trace-out":
        tracks = trace_tracks(tpath)
        assert tracks == trace_tracks(jpath)
        assert (1000, 0, "request a") in tracks


def test_the_flag_set_is_the_jax_clis():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(tcli.build_parser()) - flags(jcli.build_parser()) == {
        "--device"}
    assert flags(jcli.build_parser()) <= flags(tcli.build_parser())


def test_default_device_without_a_card_fails(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = run(tcli.main, [GRAPH, "-k", "2"], capsys)
    assert rc == 1 and "CUDA is not available" in err


def test_python_dash_m_runs_the_cli(tmp_path):
    """`python -m kaminpar_tpu_torch` (without a card: the default
    device's loud failure); the help names the device flag."""
    assert "--device" in tcli.build_parser().format_help()
    run_ = subprocess.run(
        [sys.executable, "-m", "kaminpar_tpu_torch", GRAPH, "-k", "2"],
        capture_output=True, text=True, timeout=120)
    import torch

    if not torch.cuda.is_available():
        assert run_.returncode == 1
        assert "CUDA is not available" in run_.stderr


def test_interrupt_exit_closes_open_scopes_and_writes_the_report(
        tmp_path, capsys):
    """A forced interrupt mid-run: the open timer scopes are closed, the
    report carries the interruption, and the exit code is 130."""
    report = tmp_path / "interrupted.json"
    args = tcli.build_parser().parse_args(
        [GRAPH, "-k", "2", "--report-json", str(report)])
    ttel.enable()
    ttel.reset()
    timer = ttimer.GLOBAL_TIMER
    timer.reset()
    # a scope left open, as a second SIGINT leaves one
    timer._stack.append(timer.root.child("partitioning"))
    assert not timer.idle()
    assert tcli._emergency_interrupt_exit(args, 0.0) == 130
    assert timer.idle()
    data = json.loads(report.read_text())
    assert data["run"]["interrupted"] and data["result"]["cut"] == -1
    assert data["anytime"]["reason"] == "keyboard-interrupt"
    assert "1 open timer scope(s) closed" in capsys.readouterr().err
