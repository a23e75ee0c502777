"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric it names found by name."""

import json
import re

import pytest

from portbench import cells

BENCH = cells.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CHECKS = {"failed", "out_of_range", "overload", "cut_gap", "cut_frac_mean"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not any(
        c in text for c in "\n\r\t")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((cells.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.fullmatch(path) and ".." not in path.split("/")
        assert (cells.REPO / path).is_dir()
    command = BENCH["command"]
    assert 1 <= len(command) <= 32 and all(one_line(w) for w in command)
    assert (cells.REPO / command[1]).is_file()
    assert command[1].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_run_seconds_fits_a_full_check_of_24_cells():
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [entry["name"] for entry in group]
        assert len(names) == len(set(names))
        assert all(NAME.fullmatch(n) for n in names)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert one_line(entry["source"]) and one_line(entry["why"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    spec = cells.config(entry["name"])
    assert spec["name"] == entry["name"]
    assert spec["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert all(NAME.fullmatch(k) and k in spec for k in entry["reduced"])
    assert callable(cells.generator(spec["generator"]).generate)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert one_line(entry["why"]) and entry["chips"] in (1, 4)
    assert NAME.fullmatch(entry["config"]) and NAME.fullmatch(entry["traffic"])
    spec = json.loads((cells.HERE / "workloads" /
                       f"{entry['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == entry[key]
    assert set(spec["limits"]) == CHECKS
    traffic = cells.traffic(entry["traffic"])
    assert {"preset", "k", "epsilon"} <= set(traffic)
    reported = cells.end_to_end(entry["name"], BENCH)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert cells.per_layer_names(entry["name"], BENCH)


def test_cells_are_unique_pairs_and_few_use_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert UNIT.fullmatch(metric["unit"]) and metric["better"] in (
        "lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_setup_s_is_there():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert one_line(metric["layer"]) and UNIT.fullmatch(metric["unit"])
    module = cells.metric(metric["name"])
    assert (module.LAYER, module.UNIT, module.MOVES) == (
        metric["layer"], metric["unit"], metric["moves"])
    assert callable(module.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
        assert metric["moves"] in {
            m["name"] for m in cells.end_to_end(cell, BENCH)}


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        cells.config("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        cells.metric("no.such_metric")
