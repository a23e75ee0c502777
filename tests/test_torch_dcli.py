"""The port's distributed command line (python -m kaminpar_tpu_torch.dcli)
against the JAX package's dcli, in process: on graph files the test
writes from factory graphs (METIS, ParHiP, a compressed container) and on
`gen:` inputs, the written partitions are bitwise equal; `--comm-table`
lists the JAX package's (phase, collective, shape) keys with the same
payload bytes per device of one call; `--heartbeat-file`,
`--metrics-file` and `--trace-out` (and the two variables) give the JAX
dcli's files; the serving flags and the shared-memory-only flags exit 2
with the JAX dcli's messages.
"""

import os
import signal

import numpy as np
import pytest

from kaminpar_tpu import dcli as jdcli
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs import factories as jf
from kaminpar_tpu.graphs.compressed import compress_host_graph as jcompress
from kaminpar_tpu.io import write_compressed as jwrite_compressed
from kaminpar_tpu.io.metis import write_metis as jwrite_metis
from kaminpar_tpu.io.parhip import write_parhip as jwrite_parhip
from kaminpar_tpu.telemetry import metrics as jmetrics
from kaminpar_tpu.telemetry import tracing as jtracing
from kaminpar_tpu_torch import dcli as tdcli
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.telemetry import metrics as tmetrics
from kaminpar_tpu_torch.telemetry import tracing as ttracing
from torch_threads import one_torch_thread  # noqa: F401

SPEC = "gen:rmat;n=4096;m=30000;seed=3"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
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
    for mod in (jtel, ttel):
        mod.disable()
    for mod in (jres, tres, jtel, ttel, jmetrics, tmetrics):
        mod.reset()
    for mod in (jtracing, ttracing):
        mod.reset_traces()


def run_both(argv, tmp_path, capsys, n=8):
    """Both dclis on argv; returns (jax stdout, port stdout, partition)."""
    outs, parts = [], []
    for name, main, extra in (("jax", jdcli.main, []),
                              ("port", tdcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.part"
        rc = main(argv + ["-n", str(n), "-o", str(out)] + extra)
        assert rc == 0, name
        outs.append(capsys.readouterr().out)
        parts.append(np.loadtxt(out, dtype=np.int64))
    np.testing.assert_array_equal(parts[1], parts[0])
    return outs[0], outs[1], parts[1]


def comm_rows(text):
    rows = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 5 and cells[3].isdigit():
            rows[(cells[0], cells[1], cells[2])] = (int(cells[3]),
                                                   int(cells[4]))
    return rows


def test_gen_input_and_comm_table(tmp_path, capsys):
    jout, tout, part = run_both([SPEC, "-k", "8", "-s", "1",
                                 "--comm-table"], tmp_path, capsys)
    assert part.shape == (4096,)
    j, t = comm_rows(jout), comm_rows(tout)
    assert j, jout
    # every key the JAX package traced is called here, with the same
    # payload per call (the JAX table sums the payload over traced calls)
    for key, (calls, nbytes) in j.items():
        assert key in t, key
        assert t[key][1] * calls == nbytes, key
    assert "per CALL" in tout


@pytest.mark.parametrize("fmt", ["metis", "parhip", "compressed"])
def test_graph_files_written_from_factory_graphs(tmp_path, capsys, fmt):
    g = jf.make_rmat(1 << 11, 16_000, seed=5)
    path = tmp_path / ("g.npz" if fmt == "compressed" else f"g.{fmt}")
    if fmt == "metis":
        jwrite_metis(g, str(path))
    elif fmt == "parhip":
        jwrite_parhip(g, str(path))
    else:
        jwrite_compressed(str(path), jcompress(g))
    _, tout, _ = run_both([str(path), "-k", "4", "-s", "2", "-f", fmt],
                          tmp_path, capsys, n=2)
    assert "TIME io=" in tout


def test_stream_chunks_and_preset(tmp_path, capsys):
    run_both(["gen:rmat;n=2048;m=16000;seed=7", "-k", "4", "-P", "fast",
              "--stream-chunks", "3"], tmp_path, capsys, n=4)


@pytest.mark.parametrize("flag", [["--serve-batch", "b.json"],
                                  ["--serve-isolation", "process"]])
def test_serving_flags_exit_2_with_the_jax_dclis_message(capsys, flag):
    argv = [SPEC, "-k", "4"] + flag
    assert jdcli.main(argv) == 2
    jerr = capsys.readouterr().err
    assert tdcli.main(argv + ["--device", "cpu"]) == 2
    terr = capsys.readouterr().err
    assert terr.split("—")[0] == jerr.split("—")[0]
    assert "kaminpar_tpu_torch --serve-batch" in terr


def metric_names(path):
    return {ln.split()[2] for ln in open(path).read().splitlines()
            if ln.startswith("# TYPE ")}


def trace_tracks(path):
    import json

    data = json.loads(open(path).read())
    return {(e["pid"], e["tid"], e["args"]["name"])
            for e in data["traceEvents"] if e["ph"] == "M"}


@pytest.mark.parametrize("flag", [
    "--heartbeat-file", "--metrics-file", "--trace-out",
    "KAMINPAR_TPU_HEARTBEAT_FILE", "KAMINPAR_TPU_METRICS_FILE"])
def test_heartbeat_metrics_and_trace_are_the_jax_dclis(flag, tmp_path,
                                                       capsys, monkeypatch):
    """Each flag (or variable) in both dclis on the METIS file case's run
    or the comm-table case's (JAX programs compiled once per file): equal
    partitions, a
    heartbeat file each, the JAX dcli's metric names (the collectives'
    bytes and calls, counted per call here) and the same trace tracks."""
    graph = tmp_path / "g.metis"
    jwrite_metis(jf.make_rmat(1 << 11, 16_000, seed=5), str(graph))
    files, parts = {}, []
    for name, main, extra in (("jax", jdcli.main, []),
                              ("port", tdcli.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.{flag.strip('-').lower()}")
        out = tmp_path / f"{name}.part"
        argv = [str(graph), "-k", "4", "-s", "2", "-f", "metis", "-n", "2",
                "-o", str(out)]
        if "METRICS" in flag.upper():
            # the comm-table case's run: on 2 shards the METIS graph is
            # replicated at once and calls no collective
            argv = [SPEC, "-k", "8", "-s", "1", "-n", "8", "-o", str(out)]
        if flag.startswith("KAMINPAR_TPU_"):
            monkeypatch.setenv(flag, path)
        else:
            argv += [flag, path]
        assert main(argv + extra) == 0, name
        capsys.readouterr()
        files[name] = path
        parts.append(np.loadtxt(out, dtype=np.int64))
        # the final scrape that process exit writes (atexit)
        (jmetrics if name == "jax" else tmetrics).shutdown()
        for mod in (jres, tres, jtel, ttel, jmetrics, tmetrics):
            mod.reset()
    np.testing.assert_array_equal(parts[1], parts[0])
    if "HEARTBEAT" in flag.upper():
        assert all(os.path.exists(p) for p in files.values())
    elif "METRICS" in flag.upper():
        # the JAX counters count collectives when a program is traced, so
        # programs compiled by an earlier test of this process add none
        names = metric_names(files["port"])
        assert metric_names(files["jax"]) <= names == {
            "kmp_comm_bytes_total", "kmp_comm_calls_total"}
    else:
        assert trace_tracks(files["port"]) == trace_tracks(files["jax"])


@pytest.mark.parametrize("flag", [["--scheme", "external"],
                                  ["--delta-batch", "d.json"],
                                  ["--dynamic-replicas", "2"]])
def test_shm_only_flags_exit_2_like_jax(capsys, flag):
    argv = [SPEC, "-k", "4"] + flag
    assert jdcli.main(argv) == 2
    jerr = capsys.readouterr().err
    assert tdcli.main(argv + ["--device", "cpu"]) == 2
    terr = capsys.readouterr().err
    assert jerr.split("—")[0] == terr.split("—")[0]


def test_argument_errors(capsys, monkeypatch):
    assert tdcli.main([SPEC, "-k", "4", "--resume", "--device", "cpu"]) == 2
    assert tdcli.main(["-k", "4", "--device", "cpu"]) == 1
    assert tdcli.main([SPEC, "--device", "cpu"]) == 1
    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "nosuchsite:nth=1")
    assert tdcli.main([SPEC, "-k", "4", "--device", "cpu"]) == 1
    monkeypatch.delenv("KAMINPAR_TPU_FAULTS")
    capsys.readouterr()


def test_flag_set_is_the_jax_dclis():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    jflags, tflags = flags(jdcli.build_parser()), flags(tdcli.build_parser())
    assert jflags <= tflags
    assert tflags - jflags == {"--device"}


def test_device_defaults_to_the_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    assert tdcli.main([SPEC, "-k", "4"]) == 1
    assert "--device cpu" in capsys.readouterr().err
