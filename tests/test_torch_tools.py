"""The port's tools CLI against the JAX package's: every subcommand prints
the same lines and writes the same files (`compress` the same container
arrays), `components` on the CPU gives the JAX device kernel's labels;
and the partitioner CLI's `-H` and `--statistics` print the same
statistics and give the run report the same `counters` and the same heap
tree keys (the byte counts are each platform's own).
"""

import json
import signal

import numpy as np
import pytest

from kaminpar_tpu import cli as jcli
from kaminpar_tpu import io as jio
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu import tools as jtools
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.utils import heap_profiler as jheap
from kaminpar_tpu.utils import statistics as jstats
from kaminpar_tpu_torch import cli as tcli
from kaminpar_tpu_torch import io as tio
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch import tools as ttools
from kaminpar_tpu_torch.utils import heap_profiler as theap
from kaminpar_tpu_torch.utils import statistics as tstats
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    for mod in (jstats, tstats, jheap, theap, jtel, ttel):
        mod.disable()
    for mod in (jres, tres, jtel, ttel):
        mod.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A METIS graph with isolated nodes (several components) and a
    partition of it."""
    d = tmp_path_factory.mktemp("tools")
    g = jfactories.make_rmat(1 << 11, 6000, seed=5)
    jio.write_metis(g, str(d / "g.metis"))
    part = (np.arange(g.n) * 7919 % 4).astype(np.int32)
    jio.write_partition(str(d / "g.part"), part)
    return d


def run_both(argv, files, capsys):
    """Both tools on `argv` ({out} names each package's output path);
    returns the two outputs, each with its own output path replaced."""
    outs = []
    for tag, main in (("jax", jtools.main), ("port", ttools.main)):
        out_path = str(files / f"{tag}.out")
        args = [a.format(g=files / "g.metis", part=files / "g.part",
                         out=out_path) for a in argv]
        if tag == "port" and args[0] == "components":
            args += ["--device", "cpu"]
        assert main(args) == 0
        outs.append(capsys.readouterr().out.replace(out_path, "OUT"))
    return outs


@pytest.mark.parametrize("argv", [
    ["properties", "{g}"],
    ["partition-properties", "{g}", "{part}"],
    ["decompress", "{out}.npz", "-o", "{out}"],
    ["rearrange", "{g}", "-o", "{out}"],
    ["components", "{g}", "-o", "{out}"],
    ["convert", "{g}", "-o", "{out}.parhip"],
    ["convert", "{g}", "-o", "{out}", "--to", "metis"],
])
def test_subcommand_prints_and_writes_what_the_jax_tool_does(argv, files,
                                                             capsys):
    if argv[0] == "decompress":
        # each package's decompress reads its own package's container
        g = jio.load_graph(str(files / "g.metis"))
        from kaminpar_tpu.graphs.compressed import compress_host_graph

        jio.write_compressed(str(files / "jax.out.npz"),
                             compress_host_graph(g))
        from kaminpar_tpu_torch.graphs.compressed import (
            compress_host_graph as port_compress,
        )

        tio.write_compressed(str(files / "port.out.npz"),
                             port_compress(tio.load_graph(
                                 str(files / "g.metis"))))
    jout, tout = run_both(argv, files, capsys)
    assert tout == jout and tout
    if "-o" in argv:
        suffix = argv[argv.index("-o") + 1][len("{out}"):]
        assert (files / f"port.out{suffix}").read_bytes() == (
            files / f"jax.out{suffix}").read_bytes()


def test_compress_writes_the_jax_container(files, capsys):
    jout, tout = run_both(["compress", "{g}", "-o", "{out}.npz"], files,
                          capsys)
    assert tout == jout
    a = jio.load_graph(str(files / "jax.out.npz"))
    b = tio.load_graph(str(files / "port.out.npz"))
    for name in ("xadj", "offsets", "data"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.codec == b.codec
    assert np.array_equal(a.decode().adjncy, b.decode().adjncy)


def test_partition_properties_refuses_a_short_partition(files, capsys):
    short = files / "short.part"
    short.write_text("0\n1\n")
    argv = ["partition-properties", str(files / "g.metis"), str(short)]
    assert jtools.main(argv) == ttools.main(argv) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]


def test_components_without_a_card_fails(files, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttools.main(["components", str(files / "g.metis")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_heap_profile_and_statistics_match(files, tmp_path, capsys):
    argv = [str(files / "g.metis"), "-k", "4", "-s", "1", "-H",
            "--statistics"]
    assert jcli.main(argv + ["--report-json", str(tmp_path / "j.json")]) == 0
    jout = capsys.readouterr().out
    assert tcli.main(argv + ["--report-json", str(tmp_path / "t.json"),
                             "--device", "cpu"]) == 0
    tout = capsys.readouterr().out

    def stats(out):
        lines = out.splitlines()
        start = lines.index("STATS")
        end = start + 1
        while end < len(lines) and lines[end].startswith("  "):
            end += 1
        return lines[start:end]

    assert stats(tout) == stats(jout) and len(stats(tout)) > 3
    jrep = json.loads((tmp_path / "j.json").read_text())
    trep = json.loads((tmp_path / "t.json").read_text())
    assert trep["counters"] == jrep["counters"]
    assert trep["counters"]["runs_lp"] >= 1

    def keys(tree):
        return {name: (node["count"], keys(node["children"]))
                for name, node in tree.items()}

    assert keys(trep["heap"]) == keys(jrep["heap"]) and trep["heap"]
