"""Whole runs of the harness on the CPU at the tests' size (the `tiny_bench`
cells), past the look for a card: a sound run is correct, the control and
each fault this benchmark's cells can have make `correct` false, and the
guards end a run without a result.  One run on the card (marked `cuda`)."""

import json

import numpy as np
import pytest

from portbench import run

ARGS = ["--seed", "3000000019", "--seconds", "0.5", "--trace", "0"]


def result_of(capsys, workload, device="cpu", argv=ARGS):
    rc = run.main(["--workload", workload, *argv], device=device)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), err


def wrap_partition(monkeypatch, alter):
    """Break the timed path: `alter(graph, part)` changes the partition
    that `KaMinPar.compute_partition` returns, where it is produced."""
    import kaminpar_tpu_torch as kp

    original = kp.KaMinPar.compute_partition

    def broken(self, *args, **kwargs):
        return alter(self.graph(), original(self, *args, **kwargs))

    monkeypatch.setattr(kp.KaMinPar, "compute_partition", broken)


@pytest.mark.parametrize("workload", ["t-rmat", "t-rgg"])
def test_sound_run_is_correct(tiny_bench, capsys, workload):
    rc, result, err = result_of(capsys, workload)
    assert rc == 0 and result["correct"], err
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"setup_s", "partition_s", "cut_frac",
                                      "peak_device_gib"}
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("portbench check ") for line in tail)


def test_control_twice_epsilon_is_not_correct(tiny_bench, capsys,
                                              monkeypatch):
    """The control: the program partitions with twice the cell's epsilon,
    the reference holds it to the cell's."""
    original = run.Session.partition

    def loose(self, seed):
        self.epsilon *= 2
        try:
            return original(self, seed)
        finally:
            self.epsilon /= 2

    monkeypatch.setattr(run.Session, "partition", loose)
    rc, result, err = result_of(capsys, "t-rgg")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["overload"]["value"] > 0


def test_state_unchanged_is_not_correct(tiny_bench, capsys, monkeypatch):
    """The deep scheme returns the labelling it starts from (every node in
    block 0); the output gate repairs the balance, the cut gives it away."""
    from kaminpar_tpu_torch.partitioning import deep

    monkeypatch.setattr(
        deep.DeepMultilevelPartitioner, "partition",
        lambda self, graph: np.zeros(graph.n, dtype=np.int32))
    rc, result, err = result_of(capsys, "t-rgg")
    assert rc == 0 and not result["correct"]
    checks = result["checks"]
    assert checks["cut_frac_mean"]["value"] > checks["cut_frac_mean"]["limit"]


def test_half_the_nodes_left_out_is_not_correct(tiny_bench, capsys,
                                                monkeypatch):
    """Half of the nodes keep the initial label 0; the rest as computed."""

    def halve(graph, part):
        part = part.copy()
        part[: len(part) // 2] = 0
        return part

    wrap_partition(monkeypatch, halve)
    rc, result, err = result_of(capsys, "t-rmat")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["overload"]["value"] > 0


def test_altered_answer_is_not_correct(tiny_bench, capsys, monkeypatch):
    """One node moves, after the program counted its cut, from a block that
    holds one of its neighbours to a block that holds none: the cut grows."""

    def alter(graph, part):
        part = part.copy()
        for node in range(graph.n):
            near = part[graph.adjncy[graph.xadj[node]:graph.xadj[node + 1]]]
            free = np.setdiff1d(np.arange(16), near)
            if (near == part[node]).any() and len(free):
                part[node] = free[0]
                return part
        raise AssertionError("no node to move")

    wrap_partition(monkeypatch, alter)
    rc, result, err = result_of(capsys, "t-rmat")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["cut_gap"]["value"] > 0


def test_wrong_length_is_not_correct(tiny_bench, capsys, monkeypatch):
    wrap_partition(monkeypatch, lambda graph, part: part[: len(part) // 2])
    rc, result, err = result_of(capsys, "t-rgg")
    assert rc == 0 and not result["correct"]
    assert result["checks"]["out_of_range"]["value"] > 0


def test_raising_call_is_failed(tiny_bench, capsys, monkeypatch):
    """Every call after the warm one raises: each counts as failed."""
    calls = []

    def boom(graph, part):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return part

    wrap_partition(monkeypatch, boom)
    rc, result, err = result_of(capsys, "t-rgg")
    assert rc == 0 and not result["correct"]
    assert result["failed"] == result["attempted"] >= 1
    assert "partition_s" not in result["metrics"]


def test_no_card_exits_without_result(tiny_bench, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        run.main(["--workload", "t-rgg", *ARGS], device="cuda")
    assert exit_info.value.code not in (0, None)
    assert capsys.readouterr().out.strip() == ""


def test_jax_loaded_ends_without_result(tiny_bench, capsys, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "kaminpar_tpu",
                        types.ModuleType("kaminpar_tpu"))
    rc = run.main(["--workload", "t-rgg", *ARGS], device="cpu")
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "kaminpar_tpu" in err


def test_unknown_cell_fails(tiny_bench):
    with pytest.raises(FileNotFoundError):
        run.main(["--workload", "no-such-cell", *ARGS], device="cpu")


@pytest.mark.cuda
def test_sound_run_on_the_card(tiny_bench, capsys, card):
    rc, result, err = result_of(capsys, "t-rmat", device=card)
    assert rc == 0 and result["correct"], err
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0


def test_traced_run_reports_per_layer_metrics(tiny_bench, capsys,
                                              monkeypatch):
    """On the CPU the census counts nothing and the profiler sees no device
    work, so the device metrics are left out, never given as 0."""
    import torch

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    argv = ARGS[:-1] + ["1"]
    rc, result, err = result_of(capsys, "t-rgg", argv=argv)
    assert rc == 0 and result["correct"], err
    assert set(result["metrics"]) == {
        "facade.other_s", "upload_s", "coarsening_s", "ip_s",
        "uncoarsening_s", "ops.host_syncs"}
    assert "breakdown" not in result and "busy_s" not in result["device"]
