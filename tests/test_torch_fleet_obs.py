"""The port's live metrics (telemetry/metrics.py) and latency histograms
(telemetry/perf.py) against the JAX package's, on the CPU: the same
producer calls give byte-identical Prometheus text and equal snapshots,
`WindowRate` with an injected clock gives the same rates, `Histogram`
summaries agree on the same samples, producers are no-ops while the
registry is dormant, the scrape file is published atomically and parses,
the dist mesh's collective account feeds `kmp_comm_*` per call, and the
external stream and the dist compute attach their spans to the request
trace that drives them.
"""

import re

import numpy as np
import pytest

from kaminpar_tpu.telemetry import metrics as jmetrics
from kaminpar_tpu.telemetry.perf import Histogram as JHistogram
from kaminpar_tpu_torch.telemetry import metrics as tmetrics
from kaminpar_tpu_torch.telemetry.perf import Histogram as THistogram
from torch_threads import one_torch_thread  # noqa: F401

SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? -?[0-9.e+-]+$'
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("KAMINPAR_TPU_METRICS_FILE", raising=False)
    monkeypatch.delenv("KAMINPAR_TPU_METRICS_CADENCE_S", raising=False)
    for mod in (jmetrics, tmetrics):
        mod.reset()
    yield
    for mod in (jmetrics, tmetrics):
        mod.reset()


def produce(mod):
    """One producer script: every metric kind, label sets, escapes."""
    mod.inc("kmp_requests_total", "Requests by final verdict.", 1.0,
            verdict="served")
    mod.inc("kmp_requests_total", "Requests by final verdict.", 2.0,
            verdict="rejected")
    mod.inc("kmp_comm_bytes_total", "Bytes.", value=4096, phase="lp")
    mod.inc("kmp_esc_total", "help with \\ slash\nand newline",
            cls='he said "hi"\nover\\there')
    mod.set_gauge("kmp_queue_depth", 3, "Requests admitted.")
    mod.set_gauge("kmp_queue_depth", 1, "Requests admitted.")
    mod.set_gauge("kmp_batch_occupancy", 0.6171875, "Fill fraction.")
    mod.set_gauge("kmp_worker_pool", 2.0, "Worker-pool counters.",
                  event="spawned")
    mod.set_gauge("kmp_worker_pool", 1.0, "Worker-pool counters.",
                  event="killed")
    for s in (0.0, 1e-5, 0.003, 0.25, 0.25, 1.7, 200.0):
        mod.observe("kmp_request_latency_seconds", s, "Latency.")


def test_render_is_byte_identical_to_the_jax_registry(tmp_path):
    for mod, name in ((jmetrics, "jax.prom"), (tmetrics, "port.prom")):
        mod.configure(str(tmp_path / name), cadence_s=3600.0)
        produce(mod)
    assert tmetrics.render() == jmetrics.render()
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert tmetrics.gauge_value("kmp_requests_total", verdict="served") \
        == 1.0
    for mod in (jmetrics, tmetrics):
        mod.write_now()
    assert (tmp_path / "port.prom").read_bytes() == \
        (tmp_path / "jax.prom").read_bytes()


def test_window_rate_with_an_injected_clock_is_the_jax_packages():
    t = [0.0]
    rates = []
    for mod in (jmetrics, tmetrics):
        t[0] = 0.0
        wr = mod.WindowRate("kmp_r", "rate", window_s=10.0,
                            clock=lambda: t[0])
        row = [wr.rate()]
        wr.mark()
        wr.mark(n=4)
        for now in (0.0, 5.0, 9.0, 10.5):
            t[0] = now
            row.append(wr.rate())
        t[0] = 11.0
        wr.mark(n=3)
        row.append(wr.rate())
        rates.append(row)
    assert rates[1] == rates[0]
    assert rates[1][:4] == [0.0, 5.0, 1.0, pytest.approx(5.0 / 9.0)]


@pytest.mark.parametrize("seed", [1, 2])
def test_histogram_summaries_are_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    samples = list(rng.lognormal(-3.0, 2.0, 500)) + [0.0, 1e-4, 148.0, 1e4]
    hists = (JHistogram(), THistogram())
    for h in hists:
        for s in samples:
            h.record(s)
    assert THistogram.EDGES == JHistogram.EDGES
    assert hists[1].snapshot() == hists[0].snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert hists[1].quantile(q) == hists[0].quantile(q)
    for h in hists:
        h.reset()
    assert hists[1].snapshot() == hists[0].snapshot()


def test_producers_are_noops_while_dormant():
    assert not tmetrics.enabled()
    tmetrics.inc("kmp_x_total")
    tmetrics.set_gauge("kmp_g", 1.0)
    tmetrics.observe("kmp_l_seconds", 0.1)
    tmetrics.mark("kmp_r")
    assert tmetrics.snapshot() == {}
    assert tmetrics.write_now() is None
    assert tmetrics.rate("kmp_r") == 0.0
    assert tmetrics.configure(None) is False


def test_scrape_file_is_atomic_and_parses(tmp_path, monkeypatch):
    path = tmp_path / "metrics.prom"
    monkeypatch.setenv("KAMINPAR_TPU_METRICS_FILE", str(path))
    monkeypatch.setenv("KAMINPAR_TPU_METRICS_CADENCE_S", "0.05")
    assert tmetrics.configure(None)
    produce(tmetrics)
    tmetrics.mark("kmp_requests_per_second", "rps")
    deadline = 50
    while not path.exists() and deadline:
        import time

        time.sleep(0.05)
        deadline -= 1
    assert path.exists(), "the cadence thread never wrote"
    assert tmetrics.write_now() == str(path)
    assert list(tmp_path.glob("*.tmp.*")) == []
    text = path.read_text()
    assert text.endswith("\n")
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) kmp_", line), line
        else:
            assert SAMPLE_RE.match(line), line
    assert "kmp_request_latency_seconds_count 7" in text
    tmetrics.shutdown()


def test_comm_metrics_count_every_collective_call(tmp_path):
    """The mesh's account is per call (the port runs eagerly), and the
    registry's kmp_comm_* counters equal its phase totals."""
    from kaminpar_tpu_torch.parallel import mesh
    from kaminpar_tpu_torch.resilience import runstate

    tmetrics.configure(str(tmp_path / "m.prom"), cadence_s=3600.0)
    runstate.begin()
    with mesh.comm_phase("coarsening"):
        for _ in range(3):
            mesh.account_collective("psum(x)", 1024, shape=(256,))
    with mesh.comm_phase("refinement"):
        mesh.account_collective("all_gather(y)", 512, shape=(128,))
    mesh.account_collective("outside", 8)  # no phase: not accounted
    totals = mesh.comm_phase_totals()
    snap = tmetrics.snapshot()
    assert snap["kmp_comm_bytes_total"] == {
        p: float(t["bytes_total"]) for p, t in totals.items()}
    assert snap["kmp_comm_calls_total"] == {
        p: float(t["calls"]) for p, t in totals.items()}
    assert snap["kmp_comm_calls_total"] == {"coarsening": 3.0,
                                            "refinement": 1.0}
    runstate.begin()


@pytest.mark.parametrize("layer", ["external", "dist"])
def test_deep_layers_attach_their_spans_to_the_current_trace(layer):
    """The external stream and the dist compute attach a span to the
    trace of the request that drives them (telemetry/tracing.current), as
    the JAX package's do."""
    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch import telemetry
    from kaminpar_tpu_torch.graphs.factories import make_rgg2d
    from kaminpar_tpu_torch.telemetry import tracing

    g = make_rgg2d(1000, avg_degree=8, seed=1)
    telemetry.enable()
    tracing.reset_traces()
    tid = tracing.new_trace("req", k=4)
    tracing.set_current(tid)
    try:
        if layer == "external":
            ctx = kp.context_from_preset("default")
            ctx.partitioning.mode = kp.context.PartitioningMode.EXTERNAL
            ctx.external.chunk_edges = 1 << 12
            ctx.coarsening.contraction_limit = 160
            solver = kp.KaMinPar(ctx, device="cpu")
        else:
            solver = kp.parallel.dKaMinPar("default", n_devices=2,
                                           device="cpu")
        solver.set_output_level(0)
        solver.set_graph(g).compute_partition(k=4, epsilon=0.03, seed=1)
    finally:
        tracing.set_current("")
        telemetry.disable()
    spans = tracing.get(tid)["spans"]
    tracing.reset_traces()
    assert [s["name"] for s in spans] == [f"{layer}-" + (
        "stream" if layer == "external" else "compute")]
    span = spans[0]
    assert span["origin"] == layer and span["duration_ms"] > 0
    if layer == "external":
        assert set(span["attrs"]) == {"streamed", "handoff_n"}
        assert span["attrs"]["streamed"] >= 1
    else:
        assert span["attrs"] == {"rank": 0, "devices": 2, "k": 4}
