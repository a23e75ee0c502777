"""The debug dumps (partitioning/debug.py) against the JAX package's: with
every DebugContext flag on, the deep and the k-way scheme write the same
files, byte for byte: the toplevel, coarsest and per-level graphs as
METIS and the matching partitions.  A compressed input (`terapart`) is
decoded for the dumps in both packages.

The JAX k-way scheme cannot write its per-level partitions: its staged
dump reads a partition buffer that a later launch donated
(kaminpar_tpu/partitioning/kway.py:236, "Array has been deleted"), so
for k-way that one flag is compared in the port alone."""

import os

import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from test_torch_schemes import port_context
from torch_threads import one_torch_thread  # noqa: F401

FLAGS = ("dump_toplevel_graph", "dump_toplevel_partition",
         "dump_coarsest_graph", "dump_coarsest_partition",
         "dump_graph_hierarchy", "dump_partition_hierarchy")
K = 4


def dumps(directory):
    return {name: (directory / name).read_bytes()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("preset", ["default", "mtkahypar-kway", "terapart"])
def test_dump_files_are_byte_identical(preset, tmp_path):
    host = jfactories.make_rmat(1 << 11, 12_000, seed=3)
    kway = preset == "mtkahypar-kway"
    jctx = jax_preset(preset)
    jctx.coarsening.contraction_limit = 160
    for flag in FLAGS:
        setattr(jctx.debug, flag, not (kway and flag == FLAGS[-1]))
    jctx.debug.graph_name = "rmat"
    jctx.debug.dump_dir = str(tmp_path / "jax")
    tctx = port_context(jctx)
    tctx.debug.dump_dir = str(tmp_path / "port")

    solver = kt.KaMinPar(jctx)
    solver.set_output_level(0)
    jpart = solver.set_graph(host).compute_partition(k=K, epsilon=0.03,
                                                     seed=1)
    tgraph = kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                          host.edge_weights)
    tpart = kp.KaMinPar(tctx, device="cpu").set_graph(
        tgraph).compute_partition(k=K, epsilon=0.03, seed=1)
    assert np.array_equal(jpart, tpart)

    jax_files, port_files = dumps(tmp_path / "jax"), dumps(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    assert {"rmat.toplevel.metis", "rmat.toplevel.part",
            "rmat.coarsest.metis", "rmat.coarsest.part",
            "rmat.level1.metis"} <= set(port_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    if kway:
        # the port's own per-level partitions: one file per graph level
        # below the coarsest, each a labeling of that level's graph
        tctx.debug.dump_partition_hierarchy = True
        tctx.debug.dump_dir = str(tmp_path / "port-levels")
        kp.KaMinPar(tctx, device="cpu").set_graph(tgraph).compute_partition(
            k=K, epsilon=0.03, seed=1)
        levels = dumps(tmp_path / "port-levels")
        graphs = sorted(n for n in levels if n.startswith("rmat.level")
                        and n.endswith(".metis"))
        parts = sorted(n for n in levels if n.startswith("rmat.level")
                       and n.endswith(".part"))
        assert len(parts) == len(graphs) and "rmat.level0.part" in parts
        level0 = np.loadtxt(tmp_path / "port-levels" / "rmat.level0.part",
                            dtype=np.int64)
        core_n = int((np.diff(host.xadj) > 0).sum())  # isolated removed
        assert level0.shape == (core_n,) and level0.max() < K
    else:
        assert "rmat.level0.part" in port_files
