"""The port's checkpoints, resume and anytime wind-down against the JAX
package's, at zero tolerance: snapshots written by either package read in
the other, the graph fingerprints agree, a hard stop (SimulatedPreemption
after a barrier's checkpoint) and a resume give both packages the same
partition — the uninterrupted one — at every barrier kind of the deep
scheme (test_torch_checkpoint_schemes.py has k-way, v-cycle, external and
RB), the soft stops give the same anytime partitions and `last_anytime`,
and the mismatch, corrupt-generation and write-fault degradations match.  The run report of
a budgeted, checkpointed, resumed run validates against the port's schema.
"""

import json
import os

import numpy as np
import pytest

from kaminpar_tpu.graphs import compressed as jcomp
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.io import snapshot as jsnap
from kaminpar_tpu.resilience import checkpoint as jckpt
from kaminpar_tpu_torch.graphs import compressed as tcomp
from kaminpar_tpu_torch.io import snapshot as tsnap
from kaminpar_tpu_torch.resilience import checkpoint as tckpt
from kaminpar_tpu_torch.telemetry import report as treport
from test_torch_resilience import (  # noqa: F401
    _clean,
    assert_same,
    port_graph,
    run_one,
    run_pair,
)
from torch_threads import one_torch_thread  # noqa: F401

K = 8


@pytest.fixture(scope="module")
def parity_graph():
    return jfactories.make_rmat(1 << 14, 120_000, seed=3)


@pytest.fixture(scope="module")
def small():
    return jfactories.make_rmat(1 << 12, 30_000, seed=3)


@pytest.fixture(scope="module")
def uninterrupted(parity_graph):
    return run_one("jax", "default", parity_graph, K,
                   contraction_limit=2000).part


def dirs(tmp_path, name):
    return (tmp_path / f"jax-{name}", tmp_path / f"port-{name}")


def kill_and_resume(preset, host, stop, tmp_path, configure=None, **kw):
    """Both packages stopped hard at `stop`, then resumed from their own
    checkpoint directories; returns the resumed (JAX, port) runs."""
    ck = dirs(tmp_path, stop.replace(":", "-").rstrip("!"))
    j, t = run_pair(preset, host, K, env={"KAMINPAR_TPU_STOP_AT": stop},
                    configure=configure, ckdirs=ck, **kw)
    assert type(j.error).__name__ == "SimulatedPreemption", j.error
    assert type(t.error).__name__ == "SimulatedPreemption", t.error
    jman = json.load(open(ck[0] / "manifest.json"))
    tman = json.load(open(ck[1] / "manifest.json"))
    for key in ("stage", "level", "scheme", "generation",
                "graph_fingerprint"):
        assert tman[key] == jman[key], key
    assert sorted(tman["snapshots"]) == sorted(jman["snapshots"])
    return run_pair(preset, host, K, configure=configure, ckdirs=ck,
                    resume=True, **kw)


# --- snapshots and fingerprints ----------------------------------------------


@pytest.mark.parametrize("writer,reader", [(tsnap, jsnap), (jsnap, tsnap)],
                         ids=["port-to-jax", "jax-to-port"])
def test_snapshots_read_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "snap.npz")
    arrays = {"partition": np.arange(100, dtype=np.int32) % 7,
              "spans": np.asarray([[0, 4], [4, 4]], dtype=np.int64),
              "edge_w": np.zeros(0, dtype=np.int64)}
    nbytes, sha = writer.write_snapshot(path, arrays)
    assert nbytes == os.path.getsize(path)
    back = reader.read_snapshot(path, sha)
    assert sorted(back) == sorted(arrays)
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype
        np.testing.assert_array_equal(back[name], a)
    assert reader._hash_file(path) == (nbytes, sha)
    with open(path, "r+b") as f:
        f.truncate(nbytes // 2)
    with pytest.raises(reader.SnapshotError):
        reader.read_snapshot(path, sha)
    np.savez(path, partition=np.zeros(3))  # no magic
    with pytest.raises(reader.SnapshotError, match="not a kaminpar-tpu"):
        reader.read_snapshot(path)


def test_graph_fingerprints_equal(small, parity_graph):
    for host in (small, parity_graph):
        assert tckpt.graph_fingerprint(port_graph(host)) == (
            jckpt.graph_fingerprint(host))
        jc = jcomp.compress_host_graph(host, codec="gap")
        tc = tcomp.compress_host_graph(port_graph(host), codec="gap")
        assert tckpt.graph_fingerprint(tc) == jckpt.graph_fingerprint(jc)
    assert tckpt.graph_fingerprint(port_graph(small)) != (
        tckpt.graph_fingerprint(port_graph(parity_graph)))


def test_ctx_fingerprint_ignores_the_resilience_knobs():
    import kaminpar_tpu_torch as kp

    a = kp.context_from_preset("default")
    b = kp.context_from_preset("default")
    b.resilience.resume = True
    b.resilience.checkpoint_dir = "elsewhere"
    b.resilience.memory_budget = 1e6
    assert tckpt.ctx_fingerprint(a) == tckpt.ctx_fingerprint(b)
    b.seed = 99
    assert tckpt.ctx_fingerprint(a) != tckpt.ctx_fingerprint(b)


def test_barrier_without_a_manager_builds_nothing():
    def payload():
        raise AssertionError("a payload was built without a manager")

    tckpt.deactivate()
    assert tckpt.barrier("coarsen", level=1, scheme="deep", payload=payload)


# --- kill and resume ---------------------------------------------------------


@pytest.mark.parametrize("stop", ["coarsen:1!", "initial!", "uncoarsen:1!",
                                  "result!"])
def test_deep_kill_and_resume_bitwise(parity_graph, uninterrupted, tmp_path,
                                      stop):
    j, t = kill_and_resume("default", parity_graph, stop, tmp_path,
                           contraction_limit=2000)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, uninterrupted)
    want = [e for e in j.events["resume"]]
    assert t.events["resume"] == want
    resumed = [e for e in t.events["checkpoint"]
               if e.get("action") == "resumed"]
    assert len(resumed) == 1
    assert resumed[0]["stage"] == stop.rstrip("!").split(":")[0]


# --- the anytime wind-down ---------------------------------------------------


@pytest.mark.parametrize("stop", ["coarsen:1", "initial", "uncoarsen:1"])
def test_soft_stop_bitwise(parity_graph, stop):
    j, t = run_pair("default", parity_graph, K,
                    env={"KAMINPAR_TPU_STOP_AT": stop},
                    contraction_limit=2000)
    assert_same(j, t)
    jt, tt = j.solver.last_anytime, t.solver.last_anytime
    assert tt["anytime"] and tt["reason"].startswith("stop-at:")
    jt.pop("elapsed_s", None)
    tt.pop("elapsed_s", None)
    assert tt == jt
    assert [e["reason"] for e in t.events["deadline"]] == [
        e["reason"] for e in j.events["deadline"]]
    assert [(e["level"], e["algorithm"]) for e in t.events["refine-skipped"]
            ] == [(e["level"], e["algorithm"])
                  for e in j.events["refine-skipped"]]


# --- degradations ------------------------------------------------------------


def test_mismatch_degrades_to_a_clean_restart(small, tmp_path):
    ck = dirs(tmp_path, "mismatch")
    run_pair("default", small, K, ckdirs=ck)
    # a different seed: another configuration's checkpoint
    j, t = run_pair("default", small, K, ckdirs=ck, resume=True, seed=2)
    assert_same(j, t, skip=("detail",))
    fresh = run_one("jax", "default", small, K, seed=2)
    np.testing.assert_array_equal(t.part, fresh.part)
    for run in (j, t):
        actions = [e.get("action") for e in run.events["checkpoint"]]
        assert "clean-restart" in actions and "resumed" not in actions


def test_corrupt_generation_falls_back_to_the_previous_one(small, tmp_path):
    ck = dirs(tmp_path, "corrupt")
    j, t = run_pair("default", small, K, ckdirs=ck,
                    env={"KAMINPAR_TPU_STOP_AT": "uncoarsen:1!"})
    for d in ck:
        man = json.load(open(d / "manifest.json"))
        newest = man["snapshots"]["state"]["file"]
        with open(d / newest, "r+b") as f:
            f.seek(40)
            f.write(b"\xff\xff\xff\xff")
    j, t = run_pair("default", small, K, ckdirs=ck, resume=True)
    assert_same(j, t, skip=("detail",))
    base = run_one("jax", "default", small, K)
    np.testing.assert_array_equal(t.part, base.part)
    assert [d["site"] for d in t.degraded] == ["checkpoint-load"]
    resumed = [e for e in t.events["checkpoint"]
               if e.get("action") == "resumed"]
    assert resumed[0]["stage"] == "uncoarsen" and resumed[0]["level"] == 2


def test_write_fault_degrades_to_memory_only(small, tmp_path):
    ck = dirs(tmp_path, "write")
    j, t = run_pair("default", small, K, ckdirs=ck,
                    env={"KAMINPAR_TPU_FAULTS": "checkpoint-write:nth=2"})
    assert_same(j, t)
    assert t.solver.ctx.resilience.checkpoint_dir
    summary = [e for e in t.events["checkpoint"] if "memory_only" in e]
    assert summary and summary[-1]["memory_only"]
    assert [d["site"] for d in t.degraded] == ["checkpoint-write"]


def test_report_of_a_budgeted_checkpointed_resumed_run(parity_graph,
                                                       tmp_path):
    """The report's memory_budget, checkpoint and anytime sections carry
    the JAX package's keys, and the report validates."""
    from kaminpar_tpu.telemetry import report as jreport

    def configure(ctx):
        ctx.resilience.memory_budget = 4_500_000.0

    ck = dirs(tmp_path, "report")
    run_pair("default", parity_graph, K, configure=configure, ckdirs=ck,
             env={"KAMINPAR_TPU_STOP_AT": "uncoarsen:1!"},
             contraction_limit=2000)
    run_one("jax", "default", parity_graph, K, configure=configure,
            ckdir=ck[0], resume=True, contraction_limit=2000)
    jrep = jreport.build_run_report()
    run_one("port", "default", parity_graph, K, configure=configure,
            ckdir=ck[1], resume=True, contraction_limit=2000)
    trep = treport.build_run_report()
    assert treport.validate_report(trep) == []
    # the JAX package's watermark reads its live device arrays, which
    # exist on the CPU too; the port's reads the card's allocator and
    # omits the key on the CPU
    jrep["memory_budget"].pop("watermark_bytes", None)
    for section in ("memory_budget", "checkpoint", "anytime", "integrity",
                    "faults"):
        assert sorted(trep[section]) == sorted(jrep[section]), section
    assert trep["checkpoint"]["resumed_from"] == "uncoarsen:1"
    assert trep["memory_budget"]["rung"] == 2
    for key in ("rung", "initial_rung", "budget_bytes", "estimate_bytes",
                "bucket", "spills"):
        assert trep["memory_budget"][key] == jrep["memory_budget"][key]
