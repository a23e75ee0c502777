"""The port's integrity sentinels against the JAX package's, at zero
tolerance: clean runs pass the same number of checks; a corrupted coarse
edge weight, cluster map or coarse node weight, and an out-of-range or
cut-raising refinement, trip the same invariant at the same level with
the same message; bit-flip chaos is detected, retried once from the last
clean barrier and gives the uninterrupted partition; two violations end in
`corrupt-result`; the sampled audits and the spill files' digests count
alike; the kill switch turns it all off in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.context import PartitioningMode as JMode
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.graphs.csr import device_graph_from_host as jupload
from kaminpar_tpu.partitioning.coarsener import Coarsener as JCoarsener
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.resilience import integrity as jint
from kaminpar_tpu_torch.graphs.csr import device_graph_from_host as tupload
from kaminpar_tpu_torch.partitioning.coarsener import Coarsener as TCoarsener
from kaminpar_tpu_torch.resilience import integrity as tint
from test_torch_resilience import (  # noqa: F401
    _clean,
    assert_same,
    port_graph,
    run_one,
    run_pair,
)
from test_torch_schemes import port_context
from torch_threads import one_torch_thread  # noqa: F401

K = 8


@pytest.fixture(scope="module")
def small():
    return jfactories.make_rmat(1 << 12, 30_000, seed=3)


@pytest.fixture(scope="module")
def baseline(small):
    return run_one("jax", "default", small, K).part


def summary(mod):
    s = mod.summary()
    s.pop("wall_s", None)
    return s


def test_clean_run_passes_the_same_checks(small):
    j, t = run_pair("default", small, K)
    assert_same(j, t)
    tsum = summary(tint)
    assert tsum["enabled"] and tsum["verdict"] == "clean"
    assert tsum["checks"] > 0 and not tsum["violations"]
    assert summary(jint) == tsum


def _levels(small):
    """Level 0 of both packages' coarseners on the same graph."""
    jctx = jax_preset("default")
    jctx.coarsening.contraction_limit = 160
    tctx = port_context(jctx)
    host = small
    jctx.partition.setup(host, k=K, epsilon=0.03)
    tg = port_graph(host)
    tctx.partition.setup(tg, k=K, epsilon=0.03)
    jc = JCoarsener(jctx, jupload(host), host.n)
    tc = TCoarsener(tctx, tupload(tg, "cpu"), host.n)
    assert jc.coarsen() and tc.coarsen()
    return jc.levels[0], tc.levels[0]


CORRUPTIONS = {
    "edge-weight": lambda g, cmap, arr: (
        dataclasses.replace(g, edge_w=arr(g.edge_w, 0, 1)), cmap),
    "node-weight": lambda g, cmap, arr: (
        dataclasses.replace(g, node_w=arr(g.node_w, 0, 1)), cmap),
    "cmap": lambda g, cmap, arr: (g, arr(cmap, 0, 10 ** 6)),
}


def _jarr(a, i, delta):
    a = np.array(np.asarray(a), copy=True)
    a[i] += delta
    return jnp.asarray(a)


def _tarr(a, i, delta):
    a = a.clone()
    a[i] += delta
    return a


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corrupted_contraction_trips_the_same_invariant(small, kind):
    jl, tl = _levels(small)
    violations = []
    for mod, lvl, arr in ((jint, jl, _jarr), (tint, tl, _tarr)):
        # a clean level passes
        mod.check_contraction(lvl.fine_graph, lvl.coarse.cmap,
                              lvl.coarse.graph, level=0, fine_n=lvl.fine_n,
                              coarse_n=lvl.coarse_n)
        graph, cmap = CORRUPTIONS[kind](lvl.coarse.graph, lvl.coarse.cmap,
                                        arr)
        with pytest.raises(Exception) as exc:
            mod.check_contraction(lvl.fine_graph, cmap, graph, level=0,
                                  fine_n=lvl.fine_n, coarse_n=lvl.coarse_n)
        err = exc.value
        assert type(err).__name__ == "IntegrityViolation"
        violations.append((err.invariant, err.level, err.scope_path,
                           str(err)))
    assert violations[0] == violations[1]


@pytest.mark.parametrize("before,after,k", [
    ((100, True, 0, 7), (90, True, 0, 7), 8),
    ((100, True, 0, 7), (90, True, 0, 8), 8),
    ((100, True, 0, 7), (110, True, 0, 7), 8),
    ((100, False, 0, 7), (110, True, 0, 7), 8),
    ((100, True, 0, 7), (110, False, -1, 7), 8),
])
def test_refinement_sentinels_equal(before, after, k):
    outcomes = []
    for mod in (jint, tint):
        try:
            mod.check_refinement(before, after, k=k, level=3)
            outcomes.append(None)
        except Exception as err:  # noqa: BLE001
            outcomes.append((err.invariant, err.level, str(err)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("plan", ["bit-flip:partition:nth=1",
                                  "bit-flip:contraction:nth=1",
                                  "bit-flip:partition:nth=3"])
def test_bit_flip_is_detected_retried_and_cut_identical(small, baseline,
                                                        plan):
    j, t = run_pair("default", small, K, env={"KAMINPAR_TPU_FAULTS": plan})
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, baseline)
    actions = [e["action"] for e in t.events["integrity"]]
    assert actions == [e["action"] for e in j.events["integrity"]]
    assert actions == ["chaos-corrupt", "violation", "retry", "recovered"]
    jv = [(e["invariant"], e["level"], e["scope"])
          for e in j.events["integrity"] if e["action"] == "violation"]
    tv = [(e["invariant"], e["level"], e["scope"])
          for e in t.events["integrity"] if e["action"] == "violation"]
    assert tv == jv
    assert tint.summary()["verdict"] == "recovered"


def test_two_violations_are_a_corrupt_result(small):
    j, t = run_pair("default", small, K,
                    env={"KAMINPAR_TPU_FAULTS": "bit-flip:partition"})
    assert_same(j, t)
    assert type(t.error).__name__ == "IntegrityViolation"
    assert t.error.invariant == "partition-range"
    assert tint.summary()["verdict"] == "corrupt-result"


def test_kill_switch(small, baseline, monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_INTEGRITY", "0")
    j, t = run_pair("default", small, K)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, baseline)
    assert tint.summary() == jint.summary() == {"enabled": False}
    # chaos still mutates, undetected, in both packages alike
    env = {"KAMINPAR_TPU_FAULTS": "bit-flip:contraction:nth=1"}
    j, t = run_pair("default", small, K, env=env)
    assert_same(j, t)
    assert [e["action"] for e in t.events["integrity"]] == ["chaos-corrupt"]


def test_audits_count_alike(small, baseline, monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_AUDIT_FRACTION", "0.5")
    j, t = run_pair("default", small, K)
    assert_same(j, t)
    np.testing.assert_array_equal(t.part, baseline)
    tsum = summary(tint)
    assert summary(jint)["audits"] == tsum["audits"]
    assert sum(a["audited"] for a in tsum["audits"].values()) > 0


def test_content_digests_equal():
    arrays = (np.arange(10, dtype=np.int32), np.ones((2, 3)),
              np.zeros(0, dtype=np.int64))
    assert tint.content_digest(*arrays) == jint.content_digest(*arrays)
    tint.verify_digest(tint.content_digest(*arrays), *arrays)
    with pytest.raises(Exception) as exc:
        tint.verify_digest(tint.content_digest(*arrays), arrays[0][::-1],
                           *arrays[1:], what="chunk")
    assert exc.value.invariant == "exchange-digest"
    assert tint.summary()["digests"]["mismatched"] == 1


def test_spill_corruption_is_recovered_by_a_redecode(small, tmp_path):
    """An external run with a spill directory; the first re-read of a
    spilled chunk finds a flipped byte, drops the file and decodes the
    chunk again: the same partition, one digest mismatch, both packages."""
    def configure(ctx):
        ctx.partitioning.mode = JMode.EXTERNAL
        ctx.external.chunk_edges = 1 << 13
        ctx.external.spill_dir = str(tmp_path / "spill")

    clean = run_one("jax", "default", small, K, configure=configure)

    def configure_jax(ctx):
        configure(ctx)
        ctx.external.spill_dir = str(tmp_path / "spill-jax")

    j = run_one("jax", "default", small, K, configure=configure_jax,
                env={"KAMINPAR_TPU_FAULTS": "spill-corrupt:nth=1"})
    jdig = jint.summary()["digests"]

    def configure_port(ctx):
        configure(ctx)
        ctx.external.spill_dir = str(tmp_path / "spill-port")

    t = run_one("port", "default", small, K, configure=configure_port,
                env={"KAMINPAR_TPU_FAULTS": "spill-corrupt:nth=1"})
    tdig = tint.summary()["digests"]
    np.testing.assert_array_equal(j.part, clean.part)
    np.testing.assert_array_equal(t.part, j.part)
    assert tdig == jdig and tdig["mismatched"] == 1
    assert [e["invariant"] for e in t.events["integrity"]
            if e["action"] == "violation"] == ["exchange-digest"]


def test_stale_spill_file_with_a_flipped_byte_is_refused(tmp_path):
    """A spill file from an earlier run has no digest in this process:
    its flipped byte fails the zip layer's CRC, which the port reports as
    a SnapshotError (the chunk store then decodes the chunk again)."""
    from kaminpar_tpu_torch.io import snapshot as tsnap

    path = str(tmp_path / "chunk-0.npz")
    tsnap.write_snapshot(path, {"adjncy": np.arange(5000, dtype=np.int32)})
    tint.chaos_flip_file("spill-corrupt", path)  # no plan: untouched
    assert tsnap.read_snapshot(path)["adjncy"].shape == (5000,)
    size = len(open(path, "rb").read())
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(tsnap.SnapshotError):
        tsnap.read_snapshot(path)


def test_sentinel_reductions_run_on_the_graph_device(small):
    """The probe reads one small tensor back: its inputs stay where the
    graph is (CPU here, the card on CUDA)."""
    tg = port_graph(small)
    dg = tupload(tg, "cpu")
    part = torch.zeros(dg.n_pad, dtype=torch.int32)
    caps = torch.full((2,), 10 ** 6, dtype=torch.int32)
    cut, feas, pmin, pmax = tint.refine_probe(dg, part, caps, None)
    assert (cut, feas, pmin, pmax) == (0, True, 0, 0)
