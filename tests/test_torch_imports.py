"""The port's boundaries: no JAX and nothing of kaminpar_tpu inside
kaminpar_tpu_torch or chip_smoke.py (checked on the source, by AST), the
device rule of every entry point, the presets the port runs, the numpy
hand-over helpers, and the own copies of the graph generators.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.graphs import factories as jax_factories
from kaminpar_tpu.presets import get_preset_names as jax_preset_names
from kaminpar_tpu_torch import convert, presets
from kaminpar_tpu_torch.graphs import factories as port_factories
from kaminpar_tpu_torch.device import resolve_device
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "kaminpar_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kaminpar_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0], node.lineno


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(REPO)}:{line} imports {root}"
        for f in files
        for root, line in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "io/__init__.py", "io/errors.py", "io/metis.py", "io/parhip.py",
    "io/partition.py", "io/compressed_binary.py", "telemetry/__init__.py",
    "telemetry/report.py", "telemetry/diff.py", "utils/timer.py",
    "utils/logger.py",
])
def test_scan_covers_the_file_io_and_telemetry_modules(module):
    """The AST scan above walks every subpackage, these included; each
    imports, and imports neither JAX nor the JAX package."""
    path = PACKAGE / module
    assert path in set(PACKAGE.rglob("*.py"))
    roots = {root for root, _ in _imported_roots(path)}
    assert not roots & set(FORBIDDEN)
    import importlib

    name = "kaminpar_tpu_torch." + module[:-3].replace("/", ".").removesuffix(
        ".__init__")
    importlib.import_module(name)


@pytest.mark.parametrize("module", [
    "resilience/__init__.py", "resilience/errors.py",
    "resilience/runstate.py", "resilience/faults.py",
    "resilience/policy.py", "resilience/deadline.py",
    "resilience/checkpoint.py", "resilience/memory.py",
    "resilience/integrity.py", "io/snapshot.py", "caching.py",
])
def test_scan_covers_the_resilience_modules(module):
    """The resilience layer's own copies are in the scan: each imports,
    and imports neither JAX nor the JAX package."""
    test_scan_covers_the_file_io_and_telemetry_modules(module)


@pytest.mark.parametrize("module", [
    "dynamic/__init__.py", "dynamic/session.py", "dynamic/repartition.py",
    "dynamic/driver.py", "cli.py", "tools.py", "capi.py",
    "native/build_capi.py", "bindings/__init__.py", "bindings/networkit.py",
    "partitioning/debug.py", "utils/statistics.py",
    "utils/heap_profiler.py", "graphs/factories.py",
])
def test_scan_covers_the_command_line_and_dynamic_modules(module):
    """The modules of the dynamic sessions, the command lines and the
    bindings are in the scan: each imports, and imports neither JAX nor
    the JAX package."""
    test_scan_covers_the_file_io_and_telemetry_modules(module)


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/mesh.py", "parallel/dist_graph.py",
    "parallel/dist_metrics.py", "parallel/dist_lp.py",
    "parallel/dist_balancer.py", "parallel/dist_contraction.py",
    "parallel/replication.py", "parallel/dist_context.py",
    "parallel/dist_partitioner.py", "parallel/dist_jet.py",
    "parallel/dist_coloring.py", "parallel/dist_clp.py",
    "parallel/dist_cluster_balancer.py", "parallel/dist_hem.py",
    "graphs/bfs_extractor.py", "dcli.py", "resilience/agreement.py",
    "utils/math.py",
])
def test_scan_covers_the_dist_modules(module):
    """The distributed layer, its command line and the agreement module
    are in the scan: each imports, and imports neither JAX nor the JAX
    package."""
    test_scan_covers_the_file_io_and_telemetry_modules(module)


@pytest.mark.parametrize("module", [
    "serving/__init__.py", "serving/service.py", "serving/batch.py",
    "resilience/supervisor.py", "telemetry/metrics.py",
    "telemetry/tracing.py", "telemetry/chrome_trace.py",
    "telemetry/perf.py",
])
def test_scan_covers_the_serving_and_observability_modules(module):
    """The serving layer, the supervisor, live metrics, request tracing
    and the Chrome trace are in the scan: each imports, and imports
    neither JAX nor the JAX package."""
    test_scan_covers_the_file_io_and_telemetry_modules(module)


def test_serving_exports_the_jax_names():
    import kaminpar_tpu.serving as js
    import kaminpar_tpu_torch.serving as ts

    public = {n for n in dir(js) if not n.startswith("_")} - {
        "batch", "service"}
    assert public == {"PartitionRequest", "PartitionService",
                      "RequestRecord", "ServiceConfig", "VERDICTS"}
    assert public <= set(dir(ts))
    assert ts.VERDICTS == js.VERDICTS


def test_dist_layer_exports_the_jax_names():
    """kaminpar_tpu_torch.parallel exports the JAX package's __all__."""
    import kaminpar_tpu.parallel as jp

    assert sorted(kp.parallel.__all__) == sorted(jp.__all__)
    for name in jp.__all__:
        assert hasattr(kp.parallel, name), name


@pytest.mark.parametrize("x,m", [(0, 4), (5, 4), (8, 4), (9, 256),
                                 (-3, 8)])
def test_own_copy_of_round_up(x, m):
    from kaminpar_tpu.utils import math as jmath
    from kaminpar_tpu_torch.utils import math

    assert math.round_up(x, m) == jmath.round_up(x, m)
    assert math.ceil_div(x, m) == jmath.ceil_div(x, m)


def test_entry_points_name_the_port():
    """`python -m kaminpar_tpu_torch` runs the port's CLI, and the C ABI's
    embedded interpreter imports the port's capi module."""
    main = PACKAGE / "__main__.py"
    assert not {root for root, _ in _imported_roots(main)} & set(FORBIDDEN)
    assert "from .cli import main" in main.read_text()
    cpp = (PACKAGE / "native" / "ckaminpar.cpp").read_text()
    assert 'PyImport_ImportModule("kaminpar_tpu_torch.capi")' in cpp
    assert '"kaminpar_tpu.capi"' not in cpp


def test_port_schema_is_a_copy_of_the_jax_schema():
    """The run-report schema differs from the JAX package's only in its
    comment, the environment stamp and the perf section's kernel table."""
    import json

    port = json.loads((PACKAGE / "telemetry" / "run_report.schema.json")
                      .read_text())
    ref = json.loads((REPO / "kaminpar_tpu" / "telemetry"
                      / "run_report.schema.json").read_text())
    for schema in (port, ref):
        schema.pop("$comment")
        schema["properties"].pop("environment")
        schema["properties"]["perf"]["properties"].pop("kernels", None)
    assert port == ref


def test_native_sources_are_copies_of_the_jax_packages():
    for name in ("codec.cpp", "codec2.cpp", "fm.cpp", "ip.cpp"):
        assert (PACKAGE / "native" / name).read_bytes() == (
            REPO / "kaminpar_tpu" / "native" / name).read_bytes(), name


def test_kernel_sources_live_in_the_package():
    sources = sorted(p.name for p in (PACKAGE / "csrc").glob("*.cu"))
    assert sources == ["best_from_slots.cu", "dense_ratings.cu", "gather.cu"]


@pytest.mark.parametrize("device", [None, "cuda", torch.device("cuda")])
def test_cuda_requested_without_a_card_raises(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(device) if device is not None else resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kp.KaMinPar("default") if device is None else kp.KaMinPar(
            "default", device=device)


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    assert kp.KaMinPar("default", device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_presets_of_this_slice():
    """Every preset of the JAX package builds; the `terapart*` ones switch
    on compressed-graph mode."""
    assert presets.get_preset_names() == set(jax_preset_names())
    assert kp.context_from_preset("default").preset_name == "default"
    for name in sorted(presets.get_preset_names()):
        ctx = presets.create_context_by_preset_name(name)
        assert isinstance(ctx, kp.Context)
        assert ctx.compression.enabled == name.startswith("terapart")
    with pytest.raises(ValueError):
        presets.create_context_by_preset_name("no-such-preset")


def test_labels_from_numpy():
    t = convert.labels_from_numpy(np.array([3, 0, 2], dtype=np.int64), "cpu")
    assert t.dtype == torch.int32 and t.tolist() == [3, 0, 2]
    with pytest.raises(ValueError):
        convert.labels_from_numpy(np.array([2**31]), "cpu")
    with pytest.raises(ValueError):
        convert.labels_from_numpy(np.zeros((2, 2), dtype=np.int32), "cpu")


def test_device_graph_round_trip():
    from kaminpar_tpu_torch.graphs.csr import (
        device_graph_from_host,
        host_graph_from_device,
    )

    g = kp.make_rmat(1 << 8, 900, seed=1)
    dg = device_graph_from_host(g, "cpu")
    assert dg.n_pad >= g.n + 1 and dg.n_pad % 256 == 0
    assert int(dg.src[g.m:].min()) == dg.n_pad - 1
    assert int(dg.edge_w[g.m:].abs().sum()) == 0
    back = host_graph_from_device(dg)
    np.testing.assert_array_equal(back.xadj, g.xadj)
    np.testing.assert_array_equal(back.adjncy, g.adjncy)


@pytest.mark.parametrize("name,args", [
    ("make_rmat", (1 << 10, 5000)), ("make_rmat", (1 << 12, 30_000)),
    ("make_rgg2d", (1 << 10,)), ("make_rgg2d", (3000, 12.0)),
])
@pytest.mark.parametrize("seed", [None, 7])
def test_generators_draw_the_jax_graphs(name, args, seed):
    a = getattr(jax_factories, name)(*args, seed=seed)
    b = getattr(port_factories, name)(*args, seed=seed)
    np.testing.assert_array_equal(a.xadj, b.xadj)
    np.testing.assert_array_equal(a.adjncy, b.adjncy)
    np.testing.assert_array_equal(a.node_weight_array(),
                                  b.node_weight_array())
    np.testing.assert_array_equal(a.edge_weight_array(),
                                  b.edge_weight_array())
