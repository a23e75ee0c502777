"""The port's serving layer (kaminpar_tpu_torch/serving/) against the JAX
package's, on the CPU: one mixed batch goes through both packages'
PartitionService (two identical requests of which the second is a cache
hit, `gen:` specs, a malformed file, an over-cap request, a k < 1
request, an anytime deadline, a drained tail, and a `serving-admit` /
`serving-cache` fault plan) and gives equal verdicts, reasons, cuts,
feasibility, partitions, counts and cache statistics (times excluded),
equal request traces, and Chrome traces with the same tracks and (cat,
name) pairs; the session kinds and the batch spec reader agree; cache
keys are equal; two sequential requests leave no tensor alive; and a
crashed worker fails its request alone while a fresh worker serves the
next one on the CPU.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as tkp
from kaminpar_tpu import caching as jcaching
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs.factories import make_rgg2d
from kaminpar_tpu.presets import create_context_by_preset_name as jpreset
from kaminpar_tpu.serving import PartitionRequest as JReq
from kaminpar_tpu.serving import PartitionService as JService
from kaminpar_tpu.serving import ServiceConfig as JConfig
from kaminpar_tpu.serving import batch as jbatch
from kaminpar_tpu.telemetry import chrome_trace as jchrome
from kaminpar_tpu.telemetry import tracing as jtracing
from kaminpar_tpu_torch import caching as tcaching
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.graphs.host import HostGraph
from kaminpar_tpu_torch.presets import create_context_by_preset_name as tpreset
from kaminpar_tpu_torch.resilience import supervisor as tsup
from kaminpar_tpu_torch.serving import PartitionRequest as TReq
from kaminpar_tpu_torch.serving import PartitionService as TService
from kaminpar_tpu_torch.serving import ServiceConfig as TConfig
from kaminpar_tpu_torch.serving import batch as tbatch
from kaminpar_tpu_torch.telemetry import chrome_trace as tchrome
from kaminpar_tpu_torch.telemetry import tracing as ttracing
from torch_threads import one_torch_thread  # noqa: F401

FAULTS = "KAMINPAR_TPU_FAULTS"
GRAPH = make_rgg2d(600, avg_degree=8, seed=3)
SPEC = "gen:rgg2d;n=900;avg_degree=8;seed=4"
LAST = "gen:rgg2d;n=700;avg_degree=8;seed=5"
RECORD_KEYS = ("request_id", "verdict", "reason", "error", "k", "n", "m",
               "cut", "imbalance", "feasible", "gate_valid", "cached",
               "bucket", "degraded_sites", "hard_ceiling_s")


def port_graph(g):
    return HostGraph(g.xadj, g.adjncy, g.node_weights, g.edge_weights)


def reset_both():
    for mod in (jres, tres, jtel, ttel):
        mod.reset()
    jtracing.reset_traces()
    ttracing.reset_traces()


def mixed_batch(pkg, tmp):
    req = JReq if pkg == "jax" else TReq
    graph = GRAPH if pkg == "jax" else port_graph(GRAPH)
    poison = os.path.join(tmp, "poison.metis")
    with open(poison, "w") as f:
        f.write("3 2\n1 2\n999999 1\n2\n")  # an out-of-range neighbour
    return [
        req(graph, k=4, seed=1, request_id="dup1"),
        req(graph, k=4, seed=1, request_id="dup2"),  # a cache hit
        req(SPEC, k=4, seed=2, request_id="spec"),  # serving-cache fault
        req(LAST, k=4, seed=1, request_id="admit"),  # serving-admit fault
        req("gen:rgg2d;n=4000000;avg_degree=64;seed=1", k=4,
            request_id="too-large"),
        req(graph, k=0, request_id="k0"),
        req(poison, k=4, request_id="poison"),
        req(SPEC, k=4, seed=1, deadline_s=1e-4, request_id="deadline"),
        req(LAST, k=4, seed=3, request_id="last"),
    ]


def serve_mixed(pkg, tmp):
    """The batch and its drained tail through one package's service;
    returns (records, summary, traces, chrome trace)."""
    reset_both()
    tel = jtel if pkg == "jax" else ttel
    tel.enable()
    os.environ[FAULTS] = "serving-admit:nth=4,serving-cache:nth=3"
    try:
        if pkg == "jax":
            svc = JService("default", JConfig(keep_partitions=True))
        else:
            svc = TService("default", TConfig(keep_partitions=True),
                           device="cpu")
        records = svc.serve(mixed_batch(pkg, tmp))
        req = JReq if pkg == "jax" else TReq
        for rid in ("tail1", "tail2"):
            assert svc.submit(req(LAST, k=4, seed=7, request_id=rid)) is None
        svc.drain()
        records += svc.run_pending()
        summary = svc.annotate()
        traces = (jtracing if pkg == "jax" else ttracing).traces()
        chrome = (jchrome if pkg == "jax" else tchrome).chrome_trace()
        svc.close()
        return records, summary, traces, chrome
    finally:
        del os.environ[FAULTS]
        tel.disable()
        reset_both()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serving"))
    return {pkg: serve_mixed(pkg, tmp) for pkg in ("jax", "port")}


def record_row(rec):
    d = rec.to_dict()
    return {k: d.get(k) for k in RECORD_KEYS}


def test_mixed_batch_verdicts_and_partitions_are_the_jax_services(served):
    jrecs, trecs = served["jax"][0], served["port"][0]
    assert [r.request_id for r in trecs] == [r.request_id for r in jrecs]
    by_id = {r.request_id: r for r in trecs}
    expect = {"dup1": ("served", ""), "dup2": ("served", ""),
              "spec": ("degraded", ""), "admit": ("rejected",
                                                  "fault-injected"),
              "too-large": ("rejected", "request-too-large"),
              "k0": ("rejected", "invalid-parameters"),
              "poison": ("failed", "malformed-input"),
              "deadline": ("anytime", "budget"), "last": ("served", ""),
              "tail1": ("rejected", "draining"),
              "tail2": ("rejected", "draining")}
    assert {r: (by_id[r].verdict, by_id[r].reason) for r in by_id} == expect
    assert by_id["dup2"].cached and not by_id["dup1"].cached
    assert by_id["spec"].degraded_sites == ["serving-cache"]
    for j, t in zip(jrecs, trecs):
        assert record_row(t) == record_row(j), t.request_id
        if j.partition is None:
            assert t.partition is None
        else:
            np.testing.assert_array_equal(t.partition, j.partition)


def test_mixed_batch_summary_counts_and_cache_stats(served):
    js, ts = served["jax"][1], served["port"][1]
    assert ts["counts"] == js["counts"]
    assert ts["admission"] == js["admission"]
    assert ts["cache"] == js["cache"]
    assert ts["drained"] == js["drained"] is True
    assert set(ts) == set(js)
    assert set(ts["latency"]["phases"]) == set(js["latency"]["phases"])
    assert set(ts["latency"]["classes"]) == set(js["latency"]["classes"])
    json.dumps(ts)


def test_request_traces_are_the_jax_services(served):
    def shape(traces):
        return [(t["request_id"], t["attrs"],
                 [(s["name"], s["origin"], s["attrs"]) for s in t["spans"]])
                for t in traces]

    jt, tt = served["jax"][2], served["port"][2]
    assert shape(tt) == shape(jt)
    names = {s[0] for t in shape(tt) for s in t[2]}
    assert {"admission", "queue-wait", "compute", "gate"} <= names


# What the JAX trace holds and this package's cannot yet: the counter
# tracks and events of the observatory modules (progress series, memory
# watermarks, the transfer ledger; ROADMAP.md Queue 1), the native IP's
# scope (the port's IP may run on worker threads, which the timer's one
# scope stack does not follow), and two scheme phases that the port's
# scope tree names as its `last_timings` keys (ROADMAP.md Queue 3).
JAX_ONLY_PAIRS = {("event", "ledger-transfer"), ("event", "perf-memory"),
                  ("ledger", "transfer-bytes"), ("perf", "memory"),
                  ("span", "ip-native")}
PORT_PHASES = {"upload": "device-upload", "extension": "extend-partition"}


def test_chrome_trace_tracks_and_pairs_are_the_jax_services(served):
    def tracks(trace):
        return {(e["pid"], e["tid"], e["args"]["name"])
                for e in trace["traceEvents"] if e["ph"] == "M"}

    def pairs(trace):
        return {(e.get("cat"), e["name"]) for e in trace["traceEvents"]
                if e["ph"] != "M"}

    jc, tc = served["jax"][3], served["port"][3]
    assert tracks(tc) == tracks(jc)
    jpairs = {p for p in pairs(jc)
              if p not in JAX_ONLY_PAIRS and p[0] != "progress"}
    tpairs = {(c, PORT_PHASES.get(n, n) if c == "span" else n)
              for c, n in pairs(tc)}
    assert tpairs == jpairs
    assert {("request", "compute"), ("span", "jet")} <= tpairs
    json.loads(json.dumps(tc))


def test_session_kinds_are_the_jax_services():
    spec = "gen:rgg2d;n=1000;avg_degree=8;seed=3"
    out = {}
    for pkg, req in (("jax", JReq), ("port", TReq)):
        reset_both()
        svc = (JService("default") if pkg == "jax"
               else TService("default", device="cpu"))
        recs = svc.serve([
            req(spec, k=4, kind="register", session="s1", seed=1,
                request_id="r1"),
            req(spec, k=4, kind="register", session="s1",
                request_id="r1b"),
            req("", k=0, kind="mutate", session="s1",
                delta={"edge_inserts": [[0, 999]]}, request_id="r2"),
            req("", k=0, kind="repartition", session="s1", seed=1,
                request_id="r3"),
            req("", k=0, kind="mutate", session="ghost",
                delta={"edge_inserts": [[0, 1]]}, request_id="r4"),
            req("", k=0, kind="mutate", session="s1",
                delta={"edge_deletes": [[0, 999998]]}, request_id="r5"),
            req("", k=0, kind="bogus", session="s1", request_id="r6"),
            req("", k=0, kind="repartition", session="s1", epsilon=0.1,
                seed=2, request_id="r7"),
        ])
        dyn = svc.dynamic_summary()
        for row in dyn["decisions"]:
            for key in list(row):
                if key.endswith("wall_s"):
                    row.pop(key)
        for s in dyn["sessions"]:
            s.pop("wall_s", None)
        out[pkg] = ([record_row(r) for r in recs], dyn,
                    svc._sessions["s1"].partition.copy())
    assert out["port"][0] == out["jax"][0]
    assert [r["reason"] for r in out["port"][0]] == [
        None, "duplicate-session", out["jax"][0][2]["reason"], None,
        "unknown-session", "malformed-input", "invalid-parameters", None]
    assert out["port"][1] == out["jax"][1]
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])
    reset_both()


@pytest.mark.parametrize("spec", [
    [{"graph": SPEC, "k": 4, "id": "a"}, {"graph": "x.metis", "k": 2}],
    {"config": {"max_queue_depth": 7, "default_deadline_s": 2.5,
                "keep_partitions": "false", "isolation": "process"},
     "requests": [{"graph": SPEC, "k": 4, "epsilon": 0.05, "seed": 9,
                   "priority": 2, "hard_deadline_s": 3, "id": "hi"},
                  {"kind": "register", "session": "s", "graph": SPEC,
                   "k": 2},
                  {"kind": "mutate", "session": "s",
                   "delta": {"edge_inserts": [[0, 5]]}},
                  {"kind": "repartition", "session": "s"}]},
    {"requests": []},
    {"requests": [{"graph": "x"}]},
    {"config": {"nope": 1}, "requests": [{"graph": "x", "k": 2}]},
    {"config": {"keep_partitions": "maybe"},
     "requests": [{"graph": "x", "k": 2}]},
    [{"graph": "x", "k": 2, "id": "a"}, {"graph": "y", "k": 2, "id": "a"}],
    [{"graph": "x", "k": "four"}],
    [{"kind": "mutate", "session": "s"}],
    [{"kind": "repartition"}],
    "not a batch",
])
def test_batch_spec_reader_is_the_jax_readers(spec, tmp_path):
    path = tmp_path / "batch.json"
    path.write_text(json.dumps(spec))
    results = []
    for mod in (jbatch, tbatch):
        try:
            requests, config = mod.load_batch(str(path))
        except mod.BatchSpecError as e:
            results.append(("refused", str(e)))
            continue
        results.append((
            "accepted",
            [{k: v for k, v in vars(r).items()} for r in requests],
            {k: v for k, v in vars(config).items()},
        ))
    assert results[1] == results[0]


@pytest.mark.parametrize("preset,k", [("default", 4), ("fast", 8),
                                      ("strong", 2)])
def test_result_cache_keys_are_the_jax_packages(preset, k):
    jctx, tctx = jpreset(preset), tpreset(preset)
    for ctx in (jctx, tctx):
        ctx.seed = 3
        ctx.partition.k = k
        ctx.partition.epsilon = 0.05
    jkey = jcaching.result_cache_key(GRAPH, jctx)
    assert tcaching.result_cache_key(port_graph(GRAPH), tctx) == jkey


def test_bounded_cache_is_the_jax_packages():
    caches = (jcaching.BoundedCache(3, 100), tcaching.BoundedCache(3, 100))
    for c in caches:
        for i in range(6):
            c.put(("k", i), i, nbytes=30 + i)
        c.get(("k", 5))
        c.get(("k", 0))
        c.put("big", 0, nbytes=101)
        c.evict(("k", 4))
        c.begin_window()
        c.get(("k", 5))
        c.evict_to(0)
    assert caches[1].stats() == caches[0].stats()


def test_governor_sheds_the_service_cache(monkeypatch):
    """A request under device-memory pressure sheds the registered result
    cache (the governor reads no live bytes on the CPU, so the pressure
    is forced)."""
    from kaminpar_tpu_torch.resilience import memory

    reset_both()
    svc = TService("default", device="cpu")
    svc.serve([TReq(LAST, k=2, seed=3, request_id="a")])
    assert svc.result_cache_stats()["bytes"] > 0
    freed = memory.shed_caches(0)
    stats = svc.result_cache_stats()
    assert freed > 0 and stats["bytes"] == 0
    assert stats["evictions_pressure"] == 1


def live_tensors():
    gc.collect()
    return sum(1 for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor))


def test_two_sequential_runs_share_process_without_state_leak(tmp_path):
    """Run A is preempted mid-pipeline with a checkpoint on disk; run B in
    the same process neither resumes from A's state nor inherits its stop
    verdict; and two served requests leave no tensor alive."""
    from kaminpar_tpu_torch.resilience import checkpoint as ckpt_mod
    from kaminpar_tpu_torch.resilience import deadline as deadline_mod
    from kaminpar_tpu_torch.resilience.checkpoint import SimulatedPreemption

    reset_both()
    ttel.enable()
    g = port_graph(make_rgg2d(800, avg_degree=8, seed=3))
    ctx_a = tpreset("default")
    ctx_a.coarsening.contraction_limit = 50
    ctx_a.resilience.checkpoint_dir = str(tmp_path / "ckpt")
    os.environ[ckpt_mod.STOP_AT_ENV] = "coarsen:1!"
    try:
        with pytest.raises(SimulatedPreemption):
            solver_a = tkp.KaMinPar(ctx_a, device="cpu")
            solver_a.set_output_level(0)
            solver_a.set_graph(g).compute_partition(k=4, epsilon=0.03,
                                                    seed=1)
    finally:
        os.environ.pop(ckpt_mod.STOP_AT_ENV, None)
    assert (tmp_path / "ckpt" / "manifest.json").exists()
    ctx_b = tpreset("default")
    ctx_b.coarsening.contraction_limit = 50
    ctx_b.resilience.checkpoint_dir = str(tmp_path / "ckpt-b")
    solver_b = tkp.KaMinPar(ctx_b, device="cpu")
    solver_b.set_output_level(0)
    part = solver_b.set_graph(g).compute_partition(k=4, epsilon=0.03,
                                                   seed=1)
    assert part.shape == (g.n,) and solver_b.last_anytime is None
    actions = [e.attrs.get("action") for e in ttel.events("checkpoint")]
    assert "resumed" not in actions and not deadline_mod.triggered()
    del solver_a, solver_b
    ttel.disable()

    svc = TService("default", device="cpu")
    svc.serve([TReq(g, k=4, seed=1, request_id="warm")])
    svc._result_cache.clear()
    before = live_tensors()
    recs = svc.serve([TReq(g, k=4, seed=1, request_id="a"),
                      TReq(LAST, k=2, seed=3, request_id="b")])
    assert [r.verdict for r in recs] == ["served", "served"]
    assert live_tensors() <= before
    reset_both()


def test_marshalled_errors_reraise_as_the_jax_supervisors():
    """A failure marshalled across the worker boundary comes back as its
    own type in both packages (the breaker sees what it would in-process),
    and both marshal it to the same message."""
    from kaminpar_tpu.io import GraphFormatError as JFormatError
    from kaminpar_tpu.resilience import supervisor as jsup

    from kaminpar_tpu_torch.io.errors import GraphFormatError

    def cases(res, fmt_error):
        oom = res.DeviceOOM("out of memory", site="device-oom")
        oom.rungs_exhausted = True
        return [oom,
                res.StageHang("stuck", site="worker-hang", stage="partition",
                              scope_path="partitioning.coarsening",
                              ceiling_s=2.0),
                res.RefinerRefused("no", site="refiner"),
                fmt_error("bad file"), ValueError("v"), KeyError("k"),
                RuntimeError("CUDA is not available")]

    def roundtrip(sup, exc):
        try:
            sup._raise_marshalled(sup._marshal_error(exc))
        except BaseException as e:  # noqa: BLE001
            return e
        raise AssertionError("nothing raised")

    for jexc, texc in zip(cases(jres, JFormatError),
                          cases(tres, GraphFormatError)):
        assert tsup._marshal_error(texc) == jsup._marshal_error(jexc)
        got = roundtrip(tsup, texc)
        assert type(got) is type(texc)
        assert type(roundtrip(jsup, jexc)).__name__ == type(got).__name__
    oom, hang = cases(tres, GraphFormatError)[:2]
    assert roundtrip(tsup, oom).rungs_exhausted
    got = roundtrip(tsup, hang)
    assert (got.stage, got.scope_path, got.ceiling_s) == (
        "partition", "partitioning.coarsening", 2.0)


def test_worker_crash_fails_alone_and_a_fresh_worker_serves(served,
                                                             monkeypatch):
    """An injected worker crash (the worker SIGKILLs itself) gives
    failed/worker-crash; the next request is served by a fresh worker on
    the service's device, with the JAX service's partition of it.  Two
    workers are spawned."""
    reset_both()
    monkeypatch.setenv(FAULTS, "worker-crash:nth=1")
    svc = TService("default", TConfig(isolation="process",
                                      keep_partitions=True), device="cpu")
    try:
        recs = svc.serve([TReq(LAST, k=4, seed=1, request_id="crash"),
                          TReq(LAST, k=4, seed=3, request_id="last")])
        assert [(r.verdict, r.reason, r.error) for r in recs] == [
            ("failed", "worker-crash", "WorkerCrash"),
            ("served", "", "")]
        jlast = {r.request_id: r for r in served["jax"][0]}["last"]
        np.testing.assert_array_equal(recs[1].partition, jlast.partition)
        assert recs[1].cut == jlast.cut
        sup = svc.supervision_summary()
        assert sup["workers"]["spawned"] == 2
        assert sup["workers"]["crashed"] == 1
        assert svc.summary()["counts"]["worker-crash"] == 1
        # sessions cannot cross the worker boundary
        rec = svc.submit(TReq(LAST, k=2, kind="register", session="s1"))
        assert rec is not None and rec.reason == "session-isolation"
    finally:
        svc.close()
        reset_both()
