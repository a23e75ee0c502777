"""Dynamic sessions against the JAX package's, at zero tolerance: delta
validation, the CSR patch, vertex removal, in-place against rebuild
accounting and the `dynamic-apply` fault, chain digests and session
fingerprints over a chain, `seed_new_vertices`, the warm, cold, replica
and escalation decisions with bitwise partitions, a whole `run_chain`,
kill-and-resume of a chain, and the run report's `dynamic` section.

The same numpy inputs go to both packages; the port runs on the CPU.  The
graphs are the JAX tests' (`make_rgg2d(1024, avg_degree=8, seed=3)`, k=4),
and the initial partition is computed once per module, by the JAX package.
"""

import json
import os

import numpy as np
import pytest

import kaminpar_tpu.dynamic as jdyn
import kaminpar_tpu_torch.dynamic as tdyn
from kaminpar_tpu import caching as jcaching
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs.factories import make_rgg2d as jax_rgg2d
from kaminpar_tpu.graphs.host import from_edge_list as jax_edges
from kaminpar_tpu.graphs.host import host_partition_metrics
from kaminpar_tpu.io.errors import GraphFormatError as JaxFormatError
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.resilience.checkpoint import (
    graph_fingerprint as jax_graph_fingerprint,
)
from kaminpar_tpu_torch import caching as tcaching
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.graphs.factories import make_rgg2d as port_rgg2d
from kaminpar_tpu_torch.graphs.host import from_edge_list as port_edges
from kaminpar_tpu_torch.io.errors import GraphFormatError as PortFormatError
from kaminpar_tpu_torch.presets import (
    create_context_by_preset_name as port_preset,
)
from kaminpar_tpu_torch.resilience import checkpoint as tckpt
from kaminpar_tpu_torch.resilience.checkpoint import (
    SimulatedPreemption,
    ctx_fingerprint,
    graph_fingerprint as port_graph_fingerprint,
)
from kaminpar_tpu_torch.telemetry.report import (
    build_run_report,
    validate_report,
)
from torch_threads import one_torch_thread  # noqa: F401

N, K = 1024, 4
WALLS = ("wall_s", "warm_wall_s", "cold_wall_s")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("KAMINPAR_TPU_FAULTS", "KAMINPAR_TPU_STOP_AT"):
        monkeypatch.delenv(var, raising=False)
    for res, tel in ((jres, jtel), (tres, ttel)):
        res.reset()
        tel.reset()
        tel.enable()
    yield
    for res, tel in ((jres, jtel), (tres, ttel)):
        res.reset()
        tel.disable()
        tel.reset()


def graphs():
    return (jax_rgg2d(N, avg_degree=8, seed=3),
            port_rgg2d(N, avg_degree=8, seed=3))


def tiny(edges):
    """A path 0-1-2-3 plus a triangle 3-4-5-3 in both packages."""
    e = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 3]])
    return edges(6, e)


def same_graph(a, b):
    for get in (lambda g: g.xadj, lambda g: g.adjncy,
                lambda g: g.node_weight_array(),
                lambda g: g.edge_weight_array()):
        assert np.array_equal(get(a), get(b))
    assert (a.node_weights is None) == (b.node_weights is None)


def same_identity(js, ts):
    """The two sessions' chain, digest and fingerprints agree."""
    assert js.chain == ts.chain
    assert js.digest() == ts.digest()
    assert js.fingerprint() == ts.fingerprint()
    assert jax_graph_fingerprint(js.graph) == port_graph_fingerprint(
        ts.graph) == ts.fingerprint()
    assert jcaching.full_graph_digest(js.graph) == tcaching.full_graph_digest(
        ts.graph) == ts.digest()


def without_walls(row):
    return {k: v for k, v in row.items() if k not in WALLS}


_INITIAL = {}


def initial_partition():
    """The JAX package's cold partition of the module graph (once)."""
    if "part" not in _INITIAL:
        g, _ = graphs()
        solver = JaxKaMinPar(jax_preset("default"))
        solver.set_output_level(0)
        part = solver.set_graph(g).compute_partition(k=K, seed=1)
        _INITIAL["part"] = np.asarray(part, dtype=np.int32)
        _INITIAL["cut"] = int(host_partition_metrics(g, part, K)["cut"])
    return _INITIAL["part"].copy(), _INITIAL["cut"]


def session_pair(sid="s"):
    """Both packages' sessions over the module graph, the same initial
    partition committed."""
    jg, tg = graphs()
    part, cut = initial_partition()
    js, ts = jdyn.GraphSession(sid, jg, k=K), tdyn.GraphSession(sid, tg, k=K)
    js.commit_partition(part.copy(), cut, gate_valid=True)
    ts.commit_partition(part.copy(), cut, gate_valid=True)
    return js, ts


# ---------------------------------------------------------------------------
# validation and the CSR patch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta,frag", [
    ({"edge_inserts": [[0, 99]]}, "out of range"),
    ({"edge_inserts": [[2, 2]]}, "self loops"),
    ({"edge_inserts": [[0, 1]]}, "already exists"),
    ({"edge_inserts": [[0, 4], [4, 0]]}, "duplicate pair"),
    ({"edge_deletes": [[0, 5]]}, "does not exist"),
    ({"edge_deletes": [[0, 1], [1, 0]]}, "duplicate pair"),
    ({"edge_weight_updates": [[0, 5]], "update_weights": [2]},
     "does not exist"),
    ({"edge_weight_updates": [[0, 1]]}, "requires update_weights"),
    ({"edge_inserts": [[0, 4]], "insert_weights": [0]}, ">= 1"),
    ({"vertex_removes": [9]}, "out of range"),
    ({"vertex_removes": [1, 1]}, "duplicate"),
    ({"node_weight_updates": [[1, 0]]}, ">= 1"),
    ({"vertex_adds": -1}, ">= 0"),
    ({"bogus_key": 1}, "unknown delta key"),
])
def test_delta_validation_errors(delta, frag):
    messages = []
    for dyn, edges, err in ((jdyn, jax_edges, JaxFormatError),
                            (tdyn, port_edges, PortFormatError)):
        s = dyn.GraphSession("v", tiny(edges), k=2)
        chain = s.chain
        with pytest.raises(err) as ei:
            s.apply(dyn.DeltaBatch.from_dict(delta))
        messages.append(str(ei.value))
        # a failed apply leaves the session untouched
        assert s.chain == chain and s.deltas_applied == 0
    assert frag in messages[1] and messages[0] == messages[1]


@pytest.mark.parametrize("delta", [
    {"edge_inserts": [[0, 2], [1, 6]], "insert_weights": [3, 1],
     "edge_deletes": [[3, 4]], "edge_weight_updates": [[0, 1]],
     "update_weights": [7], "vertex_adds": 1,
     "node_weight_updates": [[2, 5]]},
    {"edge_deletes": [[0, 1]], "edge_inserts": [[0, 1]],
     "insert_weights": [9]},
    {"vertex_adds": 2, "add_weights": [4, 2], "edge_inserts": [[6, 7]]},
])
def test_patch_equals_the_jax_patch(delta):
    js = jdyn.GraphSession("p", tiny(jax_edges), k=2)
    ts = tdyn.GraphSession("p", tiny(port_edges), k=2)
    assert js.apply(jdyn.DeltaBatch.from_dict(delta)) == ts.apply(
        tdyn.DeltaBatch.from_dict(delta))
    same_graph(js.graph, ts.graph)
    same_identity(js, ts)
    # the patched graph is the graph built from scratch
    rebuilt = port_edges(
        ts.graph.n, np.stack([ts.graph.edge_sources(), ts.graph.adjncy],
                             axis=1),
        edge_weights=ts.graph.edge_weight_array(),
        node_weights=ts.graph.node_weights, symmetrize=False)
    same_graph(rebuilt, ts.graph)


def test_vertex_remove_compacts_and_remaps_partition():
    sessions = []
    for dyn, edges in ((jdyn, jax_edges), (tdyn, port_edges)):
        s = dyn.GraphSession("p", tiny(edges), k=2)
        s.commit_partition(np.array([0, 0, 0, 1, 1, 1], dtype=np.int32),
                           cut=1)
        s.apply(dyn.DeltaBatch.from_dict({"vertex_removes": [1]}))
        sessions.append(s)
    js, ts = sessions
    assert ts.graph.n == 5 and ts.graph.m == 8
    assert np.array_equal(ts.partition, np.array([0, 0, 1, 1, 1]))
    assert np.array_equal(js.partition, ts.partition)
    same_graph(js.graph, ts.graph)
    same_identity(js, ts)
    assert js.summary() == ts.summary()


def test_in_place_vs_rebuild_bucket_accounting():
    records = []
    for dyn, g in zip((jdyn, tdyn), graphs()):
        s = dyn.GraphSession("b", g, k=K)
        small = s.apply(dyn.random_delta_batch(s.graph, seed=5,
                                               edge_churn=0.005))
        # a delta past the padded edge bucket's slack must rebuild
        m_pad = tcaching.pad_size(max(s.graph.m, 1))
        need = (m_pad - s.graph.m) // 2 + 8
        big = s.apply(dyn.random_delta_batch(
            s.graph, seed=6,
            edge_churn=float(need + 1) / max(s.graph.m // 2, 1),
            insert_frac=1.0))
        records.append((small, big, s.tracker.stats(), s.device_epoch,
                        s.summary()))
    assert records[0] == records[1]
    small, big, stats, epoch, _ = records[1]
    assert small["in_place"] and not big["in_place"] and epoch == 1
    assert stats["hits"] >= 1 and stats["misses"] >= 2


def test_dynamic_apply_fault_forces_rebuild(monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "dynamic-apply:nth=1")
    events = []
    for dyn, g, tel in zip((jdyn, tdyn), graphs(), (jtel, ttel)):
        s = dyn.GraphSession("c", g, k=K)
        info = s.apply(dyn.random_delta_batch(s.graph, seed=5,
                                              edge_churn=0.005))
        assert not info["in_place"] and s.rebuilds == 1 and s.in_place == 0
        events.append([
            {k: e.attrs.get(k) for k in ("site", "injected", "where",
                                         "fallback")}
            for e in tel.events("degraded")])
    assert events[0] == events[1]
    assert events[1][0]["site"] == "dynamic-apply"
    assert events[1][0]["injected"]


# ---------------------------------------------------------------------------
# the chain identity
# ---------------------------------------------------------------------------


def test_chain_digests_and_fingerprints_match_over_a_chain():
    jg, tg = graphs()
    jb = jdyn.synth_chain(jg, steps=3, seed=50, edge_churn=0.01,
                          vertex_adds_every=2)
    tb = tdyn.synth_chain(tg, steps=3, seed=50, edge_churn=0.01,
                          vertex_adds_every=2)
    assert [b.digest() for b in jb] == [b.digest() for b in tb]
    assert [b.to_dict() for b in jb] == [b.to_dict() for b in tb]
    # synthesis leaves no identity stamp on the caller's graph
    assert not hasattr(tg, "_chain_digest")
    js, ts = jdyn.GraphSession("a", jg, k=K), tdyn.GraphSession("a", tg, k=K)
    same_identity(js, ts)
    part, cut = initial_partition()
    for i, (a, b) in enumerate(zip(jb, tb)):
        assert js.apply(a) == ts.apply(b)
        same_graph(js.graph, ts.graph)
        same_identity(js, ts)
        if i == 0:
            js.commit_partition(np.resize(part, js.graph.n), cut)
            ts.commit_partition(np.resize(part, ts.graph.n), cut)
            same_identity(js, ts)
    assert js.summary() == ts.summary()


def test_chain_digest_never_aliases_plain_digests():
    s = tdyn.GraphSession("a", tiny(port_edges), k=2)
    s.apply(tdyn.DeltaBatch.from_dict({"edge_inserts": [[0, 3]]}))
    assert s.digest().startswith("dyn:")
    other = tcaching.full_graph_digest(port_rgg2d(256, avg_degree=4, seed=1))
    assert not other.startswith("dyn:") and s.digest() != other
    assert tcaching.full_graph_digest(s.graph) == s.digest()
    # the checkpoint identity forks per step; the ctx identity does not
    ctx = port_preset("default")
    fp0 = port_graph_fingerprint(s.graph)
    s.apply(tdyn.DeltaBatch.from_dict({"edge_inserts": [[0, 4]]}))
    assert port_graph_fingerprint(s.graph) != fp0
    assert ctx_fingerprint(ctx) == ctx_fingerprint(port_preset("default"))


def test_seed_new_vertices_and_drift():
    cases = [
        (np.array([[0, 1], [1, 2], [3, 4], [4, 5], [2, 6], [1, 6]]), 7,
         np.array([0, 0, 0, 1, 1, 1, -1]), None),
        (np.array([[0, 1], [2, 3]]), 5, np.array([0, 0, 1, 1, -1]),
         np.array([3, 3])),
        (np.array([[0, 1], [1, 2], [2, 3]]), 4, np.array([0, 0, -1, -1]),
         None),
    ]
    for edges, n, part, caps in cases:
        out = [dyn.seed_new_vertices(make(n, edges), part.astype(np.int32),
                                     k=2, max_block_weights=caps)
               for dyn, make in ((jdyn, jax_edges), (tdyn, port_edges))]
        assert np.array_equal(out[0][0], out[1][0])
        assert out[0][1] == out[1][1] >= 1 and (out[1][0] >= 0).all()
    js, ts = session_pair()
    for s, dyn in ((js, jdyn), (ts, tdyn)):
        s.apply(dyn.random_delta_batch(s.graph, seed=12, edge_churn=0.2,
                                       insert_frac=1.0, uniform_frac=1.0))
    caps = np.full(K, N // K + 8)
    assert js.drift_estimate() == ts.drift_estimate()
    assert js.drift_estimate(caps) == ts.drift_estimate(caps)


# ---------------------------------------------------------------------------
# the warm / cold / replica policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "warm", "replica", "cold", "escalated", "uniform", "unchanged",
])
def test_repartition_decisions_are_bitwise(case):
    js, ts = session_pair()
    jctx, tctx = jax_preset("default"), port_preset("default")
    for c in (jctx, tctx):
        if case == "replica":
            c.dynamic.replicas = 2
        elif case == "cold":
            c.dynamic.drift_threshold = 0.0
        elif case == "escalated":
            # every warm cut fails a gate below the pre-delta cut
            c.dynamic.cut_gate_threshold = -1.0
    if case != "unchanged":
        uniform = 0.5 if case == "uniform" else 0.0
        for s, dyn in ((js, jdyn), (ts, tdyn)):
            s.apply(dyn.random_delta_batch(s.graph, seed=11,
                                           edge_churn=0.01,
                                           uniform_frac=uniform,
                                           vertex_adds=1))
    jout = jdyn.repartition(js, jctx, k=K, seed=1)
    tout = tdyn.repartition(ts, tctx, k=K, seed=1, device="cpu")
    assert np.array_equal(jout.partition, tout.partition)
    assert without_walls(jout.to_row("s", step=1)) == without_walls(
        tout.to_row("s", step=1))
    same_identity(js, ts)
    expected = {"warm": "warm", "replica": "replica", "cold": "cold",
                "escalated": "warm", "uniform": "warm",
                "unchanged": "warm"}[case]
    assert tout.mode == expected and tout.feasible
    # uniform churn adds intrinsic cut edges: the warm cut fails the
    # gate and escalates, as in the JAX package
    assert tout.escalated == (case in ("escalated", "uniform"))
    if case == "replica":
        assert len(tout.replica_cuts) == 2 and tout.cut == min(
            tout.replica_cuts)
    ev = [e.attrs for e in ttel.events("dynamic")
          if e.attrs.get("action") == "repartition"]
    assert ev and ev[-1]["mode"] == tout.mode


def test_repartition_with_epsilon_none_keeps_the_ctx_epsilon():
    js, ts = session_pair()
    jctx, tctx = jax_preset("default"), port_preset("default")
    jctx.partition.epsilon = tctx.partition.epsilon = 0.05
    jout = jdyn.repartition(js, jctx, k=K, seed=2)
    tout = tdyn.repartition(ts, tctx, k=K, seed=2, device="cpu")
    assert np.array_equal(jout.partition, tout.partition)
    assert tctx.partition.epsilon == 0.05


# ---------------------------------------------------------------------------
# the chain driver, kill-and-resume, the report section
# ---------------------------------------------------------------------------


def _batches():
    jg, tg = graphs()
    return (jdyn.synth_chain(jg, steps=3, seed=50, edge_churn=0.01,
                             vertex_adds_every=2),
            tdyn.synth_chain(tg, steps=3, seed=50, edge_churn=0.01,
                             vertex_adds_every=2))


def _port_ctx(ckpt_dir=None, resume=False):
    ctx = port_preset("default")
    if ckpt_dir is not None:
        ctx.resilience.checkpoint_dir = str(ckpt_dir)
        ctx.resilience.resume = resume
    return ctx


def test_run_chain_and_kill_and_resume(tmp_path):
    jb, tb = _batches()
    jpart, jsec = jdyn.run_chain(jax_rgg2d(N, avg_degree=8, seed=3), jb,
                                 jax_preset("default"), k=K, seed=1)
    tpart, tsec = tdyn.run_chain(port_rgg2d(N, avg_degree=8, seed=3), tb,
                                 _port_ctx(tmp_path / "ref"), k=K, seed=1,
                                 device="cpu")
    assert np.array_equal(jpart, tpart)
    assert jsec["cut_trajectory"] == tsec["cut_trajectory"]
    assert jsec["sessions"] == tsec["sessions"]
    assert jsec["counts"] == tsec["counts"]
    assert [without_walls(r) for r in jsec["decisions"]] == [
        without_walls(r) for r in tsec["decisions"]]

    # the same chain, hard-killed at step 1's warm v-cycle barrier
    tres.reset()
    os.environ[tckpt.STOP_AT_ENV] = "vcycle:0!"
    try:
        with pytest.raises(SimulatedPreemption):
            tdyn.run_chain(port_rgg2d(N, avg_degree=8, seed=3), tb,
                           _port_ctx(tmp_path / "kill"), k=K, seed=1,
                           device="cpu")
    finally:
        os.environ.pop(tckpt.STOP_AT_ENV, None)
    tres.reset()
    rpart, rsec = tdyn.run_chain(
        port_rgg2d(N, avg_degree=8, seed=3), tb,
        _port_ctx(tmp_path / "kill", resume=True), k=K, seed=1,
        device="cpu")
    assert np.array_equal(rpart, jpart)
    assert rsec["cut_trajectory"] == jsec["cut_trajectory"]
    assert rsec["sessions"][0]["chain"] == jsec["sessions"][0]["chain"]
    assert rsec["resumed_from_step"] == 0
    assert "resumed_from_step" not in tsec


def test_chain_state_mismatch_restarts_cleanly(tmp_path):
    _, tb = _batches()
    tb = tb[:1]
    part1, sec1 = tdyn.run_chain(port_rgg2d(N, avg_degree=8, seed=3), tb,
                                 _port_ctx(tmp_path), k=K, seed=1,
                                 device="cpu")
    jpath = tmp_path / "dynamic" / "chain-state.json"
    state = json.loads(jpath.read_text())
    assert state["step"] == 1 and state["chain"] == sec1["sessions"][0][
        "chain"][len("dyn:"):]
    state["chain"] = "poisoned"
    jpath.write_text(json.dumps(state))
    part2, sec2 = tdyn.run_chain(
        port_rgg2d(N, avg_degree=8, seed=3), tb,
        _port_ctx(tmp_path, resume=True), k=K, seed=1, device="cpu")
    assert sec2["cut_trajectory"] == sec1["cut_trajectory"]
    assert np.array_equal(part1, part2)
    assert "resumed_from_step" not in sec2


def test_load_delta_file_and_summarize(tmp_path):
    jb, tb = _batches()
    path = tmp_path / "deltas.json"
    path.write_text(json.dumps({"deltas": [b.to_dict() for b in tb]}))
    assert [b.digest() for b in tdyn.load_delta_file(str(path))] == [
        b.digest() for b in jdyn.load_delta_file(str(path))]
    path.write_text("[]")
    with pytest.raises(PortFormatError, match="non-empty array"):
        tdyn.load_delta_file(str(path))
    assert tdyn.summarize([], []) == jdyn.summarize([], []) == {
        "enabled": False}


def test_dynamic_report_section():
    _, ts = session_pair()
    ts.apply(tdyn.random_delta_batch(ts.graph, seed=21, edge_churn=0.005))
    out = tdyn.repartition(ts, port_preset("default"), k=K, seed=1,
                           device="cpu")
    section = tdyn.summarize([ts], [
        {"session": ts.id, "step": 0, "mode": "cold", "drift": None,
         "cut_before": None, "cut": 10, "feasible": True, "stable": None,
         "escalated": False, "seeded": 0, "wall_s": 0.1,
         "warm_wall_s": None, "cold_wall_s": 0.1},
        {**out.to_row(ts.id, step=1), "in_place": True},
    ])
    ttel.annotate(dynamic=section)
    report = build_run_report()
    assert report["dynamic"]["enabled"]
    assert report["dynamic"]["counts"]["warm"] == 1
    assert validate_report(report) == []
    ttel.reset()
    ttel.annotate(result={"cut": 0, "imbalance": 0.0, "feasible": True})
    assert build_run_report()["dynamic"] == {"enabled": False}
