"""The compressed-graph (TeraPart) mode end to end, bitwise against the
JAX package on make_rmat(1 << 12, 30_000, seed=3) at k=8 (isolated
nodes, merged duplicate edges as edge weights): the three `terapart*`
presets (set_graph compresses with v2; the deep scheme uploads chunk by
chunk; the isolated nodes leave through the compressed core extraction),
a gap-compressed graph handed to `set_graph` directly, a compressed input
under the k-way scheme (which decodes it), and `context_from_dict` with
the fields this slice added.
"""

import numpy as np
import pytest

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu.context import context_to_dict as jax_context_to_dict
from kaminpar_tpu.graphs import compressed as jcomp
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch import native
from kaminpar_tpu_torch.context import PartitioningMode
from kaminpar_tpu_torch.convert import context_from_dict
from kaminpar_tpu_torch.graphs import compressed as tcomp
from kaminpar_tpu_torch.graphs import csr as tcsr
from test_torch_schemes import CASES, port_context, run_preset, split_jax_dict
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("preset",
                         ["terapart", "terapart-largek", "terapart-strong"])
def test_terapart_presets_bitwise_equal(preset, monkeypatch):
    monkeypatch.delenv(native.NO_NATIVE_FM_ENV, raising=False)
    uploads = []
    original = tcsr.device_graph_from_compressed

    def counted(cgraph, *args, **kwargs):
        uploads.append(cgraph.codec)
        return original(cgraph, *args, **kwargs)

    monkeypatch.setattr(tcsr, "device_graph_from_compressed", counted)
    monkeypatch.setattr("kaminpar_tpu_torch.partitioning.deep."
                        "device_graph_from_compressed", counted)
    make, k = CASES["rmat-k8"]
    jpart, tpart = run_preset(preset, make(), k)
    np.testing.assert_array_equal(jpart, tpart)
    assert uploads == ["v2"]


@pytest.mark.parametrize("mode", ["deep", "kway"])
def test_compressed_input_bitwise_equal(mode):
    """A gap-compressed graph handed to set_graph: the deep scheme keeps
    it compressed, the k-way scheme decodes it once."""
    make, k = CASES["rmat-k8"]
    host = make()
    jctx = jax_preset("default")
    jctx.coarsening.contraction_limit = 160
    jctx.partitioning.mode = type(jctx.partitioning.mode)(mode)
    tctx = port_context(jctx)
    solver = kt.KaMinPar(jctx)
    solver.set_output_level(0)
    jpart = np.asarray(solver.set_graph(
        jcomp.compress_host_graph(host, codec="gap")).compute_partition(
        k=k, epsilon=0.03, seed=1))
    tgraph = tcomp.compress_host_graph(
        kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                     host.edge_weights), codec="gap")
    tsolver = kp.KaMinPar(tctx, device="cpu").set_graph(tgraph)
    tpart = tsolver.compute_partition(k=k, epsilon=0.03, seed=1)
    np.testing.assert_array_equal(jpart, tpart)
    assert tsolver.graph() is tgraph
    assert (tsolver._decoded is not None) == (
        tctx.partitioning.mode != PartitioningMode.DEEP)
    assert tsolver.last_gate["valid"] and tsolver.last_gate["cut_match"]


def test_context_from_dict_takes_the_new_fields():
    jctx = jax_preset("terapart-largek")
    jctx.resilience.memory_budget = float(96 << 20)
    jctx.external.chunk_edges = 1 << 15
    jctx.external.lp_rounds = 2
    jctx.external.min_stream_levels = 2
    jctx.external.max_stream_levels = 9
    jctx.external.spill_dir = "spill"
    kept, _ = split_jax_dict(jax_context_to_dict(jctx))
    ctx = context_from_dict(kept)
    assert ctx.compression.enabled
    assert ctx.coarsening.clustering.forced_kc_level
    assert ctx.resilience.memory_budget == float(96 << 20)
    e = ctx.external
    assert (e.chunk_edges, e.lp_rounds, e.min_stream_levels,
            e.max_stream_levels, e.spill_dir) == (1 << 15, 2, 2, 9, "spill")
    assert ctx.preset_name == "terapart-largek"
