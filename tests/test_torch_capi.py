"""The port's C ABI and NetworKit adapter: `capi.compute_from_pointers`
writes the JAX package's partition and returns its cut; a C program
linked to libckaminpar_tpu_torch.so (built by native/build_capi.py)
partitions through include/ckaminpar_tpu.h, from the main thread and
from a second thread, as the Python call does, and examples/c_api.c
builds against it unchanged.  Without a card and without
KAMINPAR_TPU_PLATFORM=cpu the C call fails (-1, kmp_last_error names the
cause).  The NetworKit adapter (duck-typed, networkit is not installed)
gives the JAX adapter's partition and rejects directed graphs.
"""

import os
import shutil
import subprocess
import sys
import sysconfig
import textwrap

import numpy as np
import pytest

from kaminpar_tpu.capi import compute_from_pointers as jax_compute
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu_torch.capi import compute_from_pointers as port_compute
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def csr():
    g = jfactories.make_rmat(1 << 9, 3000, seed=4)
    return (g.n, np.asarray(g.xadj, dtype=np.int64),
            np.asarray(g.adjncy, dtype=np.int32),
            np.asarray(g.edge_weight_array(), dtype=np.int32))


def call(compute, n, xadj, adjncy, adjwgt, k=4):
    out = np.full(n, -1, dtype=np.int32)
    cut = compute(n, xadj.ctypes.data, adjncy.ctypes.data, 0,
                  adjwgt.ctypes.data, out.ctypes.data, k, 0.03, 1,
                  "default")
    return cut, out


def test_compute_from_pointers_is_the_jax_call(monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_PLATFORM", "cpu")
    n, xadj, adjncy, adjwgt = csr()
    jcut, jout = call(jax_compute, n, xadj, adjncy, adjwgt)
    tcut, tout = call(port_compute, n, xadj, adjncy, adjwgt)
    assert tcut == jcut > 0
    assert np.array_equal(tout, jout) and tout.min() >= 0


def test_compute_from_pointers_runs_on_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.delenv("KAMINPAR_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n, xadj, adjncy, adjwgt = csr()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(port_compute, n, xadj, adjncy, adjwgt)
    # any value but "cpu" means the card
    monkeypatch.setenv("KAMINPAR_TPU_PLATFORM", "tpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(port_compute, n, xadj, adjncy, adjwgt)


PROGRAM = textwrap.dedent("""
    #include <pthread.h>
    #include <stdio.h>
    #include <stdlib.h>
    #include "ckaminpar_tpu.h"

    static int64_t n, *xadj;
    static int32_t *adjncy, *adjwgt, *part;
    static int64_t cut = -2;
    static kmp_partitioner *p;

    static void *compute(void *arg) {
      (void)arg;
      cut = kmp_compute_partition(p, n, xadj, adjncy, NULL, adjwgt, 4,
                                  0.03, part);
      return NULL;
    }

    int main(int argc, char **argv) {
      FILE *f = fopen(argv[1], "rb");
      if (!f || fread(&n, 8, 1, f) != 1) return 5;
      int64_t m;
      if (fread(&m, 8, 1, f) != 1) return 5;
      xadj = malloc(8 * (n + 1));
      adjncy = malloc(4 * m);
      adjwgt = malloc(4 * m);
      part = malloc(4 * n);
      if (fread(xadj, 8, n + 1, f) != (size_t)(n + 1)) return 5;
      if (fread(adjncy, 4, m, f) != (size_t)m) return 5;
      if (fread(adjwgt, 4, m, f) != (size_t)m) return 5;
      fclose(f);
      p = kmp_create("default", 1);
      if (!p) return 2;
      if (argc > 2) {  /* the call from a second thread */
        pthread_t t;
        pthread_create(&t, NULL, compute, NULL);
        pthread_join(t, NULL);
      } else {
        compute(NULL);
      }
      if (cut < 0) { fprintf(stderr, "%s\\n", kmp_last_error(p)); return 3; }
      printf("cut=%lld\\n", (long long)cut);
      for (int64_t u = 0; u < n; ++u) printf("%d\\n", part[u]);
      kmp_free(p);
      return 0;
    }
""")


def write_csr(path, n, xadj, adjncy, adjwgt):
    with open(path, "wb") as f:
        np.asarray([n, len(adjncy)], dtype=np.int64).tofile(f)
        xadj.tofile(f)
        adjncy.tofile(f)
        adjwgt.tofile(f)


def test_c_program_partitions_through_the_library(tmp_path, monkeypatch):
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ toolchain (g++ and gcc) to build the C ABI "
                    "library and the C programs that link it")
    from kaminpar_tpu_torch.native.build_capi import LIB_NAME, build

    lib = build(str(tmp_path))
    assert os.path.basename(lib) == LIB_NAME
    assert build(str(tmp_path)) == lib  # a current build is kept
    (tmp_path / "partition_csr.c").write_text(PROGRAM)
    link = [f"-I{os.path.join(REPO, 'include')}", f"-L{tmp_path}",
            "-lckaminpar_tpu_torch", f"-Wl,-rpath,{tmp_path}"]
    subprocess.run(["gcc", str(tmp_path / "partition_csr.c"), "-o",
                    str(tmp_path / "partition_csr"), "-pthread", *link],
                   check=True, capture_output=True)
    subprocess.run(["gcc", os.path.join(REPO, "examples", "c_api.c"), "-o",
                    str(tmp_path / "c_api"), *link],
                   check=True, capture_output=True)

    n, xadj, adjncy, adjwgt = csr()
    write_csr(tmp_path / "g.bin", n, xadj, adjncy, adjwgt)
    monkeypatch.setenv("KAMINPAR_TPU_PLATFORM", "cpu")
    ref_cut, ref = call(port_compute, n, xadj, adjncy, adjwgt)
    env = dict(os.environ)
    # the embedded interpreter imports kaminpar_tpu_torch from the path
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["KAMINPAR_TPU_PLATFORM"] = "cpu"
    # from a second C thread (examples/c_api.c below calls from main)
    res = subprocess.run(
        [str(tmp_path / "partition_csr"), str(tmp_path / "g.bin"), "thread"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-800:]
    lines = res.stdout.split()
    assert lines[0] == f"cut={ref_cut}"
    assert np.array_equal(np.asarray(lines[1:], dtype=np.int32), ref)

    res = subprocess.run([str(tmp_path / "c_api")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-800:]
    assert res.stdout.startswith("cut=")

    import torch

    if not torch.cuda.is_available():
        # the default is the card: -1 and the cause in kmp_last_error
        env.pop("KAMINPAR_TPU_PLATFORM")
        res = subprocess.run([str(tmp_path / "c_api")], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 1
        assert "CUDA is not available" in res.stderr


def test_library_links_the_running_interpreter():
    from pathlib import Path

    from kaminpar_tpu_torch.native.build_capi import _command

    cmd = _command(Path("x.cpp"), Path("y.so"))
    version = sysconfig.get_config_var("LDVERSION") or sys.version[:4]
    assert f"-lpython{version}" in cmd and "-shared" in cmd


class FakeNkGraph:
    """Duck-typed stand-in for networkit.Graph."""

    def __init__(self, n, edges, weights=None, directed=False):
        self._n, self._edges = n, edges
        self._w = weights or {}
        self._directed = directed

    def numberOfNodes(self):
        return self._n

    def isDirected(self):
        return self._directed

    def isWeighted(self):
        return bool(self._w)

    def iterEdges(self):
        return iter(self._edges)

    def weight(self, u, v):
        return self._w.get((u, v), 1.0)


def grid(weighted):
    edges, weights = [], {}
    for r in range(12):
        for c in range(12):
            u = r * 12 + c
            for v in ((u + 1) if c < 11 else None,
                      (u + 12) if r < 11 else None):
                if v is not None:
                    edges.append((u, v))
                    weights[(u, v)] = 1.0 + (u * 7 + v) % 3
    return FakeNkGraph(144, edges, weights if weighted else None)


@pytest.mark.parametrize("weighted", [False, True])
def test_networkit_adapter_is_the_jax_adapter(weighted):
    from kaminpar_tpu.bindings import NetworKitKaMinPar as JaxAdapter
    from kaminpar_tpu_torch.bindings import NetworKitKaMinPar
    from kaminpar_tpu_torch.bindings.networkit import networkit_to_host

    from kaminpar_tpu.bindings.networkit import (
        networkit_to_host as jax_to_host,
    )

    a, b = jax_to_host(grid(weighted)), networkit_to_host(grid(weighted))
    assert np.array_equal(a.xadj, b.xadj)
    assert np.array_equal(a.adjncy, b.adjncy)
    assert np.array_equal(a.edge_weight_array(), b.edge_weight_array())
    jpart = JaxAdapter(grid(weighted), seed=1).computePartitionWithEpsilon(
        4, 0.03)
    tpart = NetworKitKaMinPar(grid(weighted), seed=1, device="cpu")
    assert np.array_equal(tpart.computePartitionWithEpsilon(4, 0.03), jpart)
    assert tpart.computePartition(2).shape == (144,)


def test_networkit_adapter_rejects_directed_and_needs_a_card(monkeypatch):
    import torch

    from kaminpar_tpu_torch.bindings import NetworKitKaMinPar
    from kaminpar_tpu_torch.bindings.networkit import networkit_to_host

    with pytest.raises(ValueError, match="undirected"):
        networkit_to_host(FakeNkGraph(2, [(0, 1)], directed=True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NetworKitKaMinPar(grid(False)).computePartition(2)
