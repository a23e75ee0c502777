"""pytest settings of the benchmark's own tests (portbench/tests/).

`cuda` marks a test that needs an NVIDIA card; it skips without one, and
decides so in the `card` fixture, never while a module is imported.  The
`tiny_bench` fixture gives the tests cells of their own at a size the CPU
holds: the configurations with `scale` and `log2_n` 12, the real
generators, traffic and metric readers, and limits from CPU readings at
that size (portbench/tests/tiny_limits.json).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"t-rmat": ("rmat-g500", "scale"), "t-rgg": ("rgg2d-dimacs", "log2_n")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    torch = pytest.importorskip("torch")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A benchmark directory with the cells t-rmat and t-rgg (k = 16), which
    the harness finds by name in place of the real ones."""
    from portbench import cells

    root = tmp_path / "portbench"
    for kind in ("configs", "workloads", "traffic"):
        (root / kind).mkdir(parents=True)
    for kind in ("generators", "metrics"):
        (root / kind).symlink_to(HERE / kind)
    shutil.copy(HERE / "traffic" / "k16.json", root / "traffic")
    limits = json.loads((HERE / "tests" / "tiny_limits.json").read_text())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (config, key) in TINY.items():
        spec = json.loads((HERE / "configs" / f"{config}.json").read_text())
        spec[key] = 12
        (root / "configs" / f"{name}.json").write_text(json.dumps(spec))
        (root / "workloads" / f"{name}.json").write_text(json.dumps({
            "config": name, "traffic": "k16", "chips": 1, "why": "tests",
            "limits": limits[name]}))
    for metric in bench["per_layer"]:
        metric["workloads"] = list(TINY)
    monkeypatch.setattr(cells, "HERE", root)
    monkeypatch.setattr(cells, "manifest", lambda: bench)
    return root
