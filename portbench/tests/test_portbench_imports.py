"""No module of the benchmark imports JAX or the JAX package `kaminpar_tpu`
(top-level names compared whole), and the reference imports nothing of the
program."""

import ast
from pathlib import Path

import pytest

from portbench import machine

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of the absolute imports in `path`."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & set(machine.FORBIDDEN)


def test_the_program_is_imported():
    assert any("kaminpar_tpu_torch" in imported(p) for p in SOURCES)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain_numpy(path):
    assert imported(path) <= {"__future__", "math", "typing", "numpy"}
    relative = [n for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert not relative


def test_forbidden_names_are_compared_whole():
    loaded = ["kaminpar_tpu_torch", "kaminpar_tpu_torch.ops", "jaxtyping",
              "kaminpar_tpu", "kaminpar_tpu.ops", "jax", "jaxlib.xla",
              "flax.linen", "numpy"]
    assert machine.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jaxlib.xla", "kaminpar_tpu", "kaminpar_tpu.ops"]
