"""Everything the harness knows about cells, found by name in files.

- `BENCHMARK.json` at the repository's root: the manifest (cells, metrics).
- `configs/<config>.json`: a configuration; its `generator` names
  `generators/<generator>.py`, whose `generate(config, seed, device)`
  returns (n, src, dst), the graph's undirected pairs on the device.
- `traffic/<traffic>.json`: what each call asks for (preset, k, epsilon).
- `workloads/<cell>.json`: a cell: its config, traffic, chips, why, and
  the limits of the numbers its `correct` compares (`limits`).
- `metrics/<metric>.py`: a per-layer metric; module constants LAYER,
  UNIT, MOVES and a `read(records)` that returns a number or None.

A later change adds a configuration, a cell or a metric as new files and
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _named(kind: str, name: str, suffix: str) -> Path:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(kind: str, name: str):
    path = _named(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    return _load_json(REPO / "BENCHMARK.json")


def config(name: str) -> dict:
    return _load_json(_named("configs", name, ".json"))


def traffic(name: str) -> dict:
    return _load_json(_named("traffic", name, ".json"))


def cell(name: str) -> dict:
    """The cell's file, with its configuration and traffic loaded in place
    of their names."""
    spec = _load_json(_named("workloads", name, ".json"))
    spec["name"] = name
    spec["config"] = config(spec["config"])
    spec["traffic"] = traffic(spec["traffic"])
    return spec


def generator(name: str):
    return _load_module("generators", name)


def metric(name: str):
    return _load_module("metrics", name)


def per_layer_names(cell_name: str, bench: dict) -> list:
    """The per-layer metrics a traced run of `cell_name` reports: those that
    list the cell, and those without a list that move an end-to-end metric
    the cell reports."""
    reported = {m["name"] for m in bench["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])}
    return [m["name"] for m in bench["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]


def end_to_end(cell_name: str, bench: dict) -> list:
    """The end-to-end metric entries a plain run of `cell_name` reports."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
