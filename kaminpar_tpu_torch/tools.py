"""Tool subcommands (own copy of kaminpar_tpu/tools.py; analog of
apps/tools/*.cc).

The reference ships five standalone tool binaries: graph properties,
partition properties, graph compression, graph rearrangement, and
connected components.  Here they are subcommands:

    python -m kaminpar_tpu_torch.tools properties  <graph>
    python -m kaminpar_tpu_torch.tools partition-properties <graph> <part>
    python -m kaminpar_tpu_torch.tools compress    <graph> -o out.npz
    python -m kaminpar_tpu_torch.tools decompress  <graph.npz> -o out.metis
    python -m kaminpar_tpu_torch.tools rearrange   <graph> -o out.metis
    python -m kaminpar_tpu_torch.tools components  <graph> [--device cpu]
    python -m kaminpar_tpu_torch.tools convert     <graph> -o out.{metis,parhip}

Each prints and writes what the JAX package's tools do.  `components`
runs the label-contraction kernel loop (ops/components.py, K1) on the
card unless ``--device cpu`` is given; without a card it exits with an
error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from . import io as io_mod
from .device import resolve_device
from .graphs.host import (
    HostGraph,
    apply_permutation,
    count_isolated_nodes,
    degree_bucket_permutation,
)


def _load(path: str, fmt: str = "auto") -> HostGraph:
    g = io_mod.load_graph(path, fmt=fmt)
    from .graphs.compressed import CompressedHostGraph

    if isinstance(g, CompressedHostGraph):
        g = g.decode()
    return g


def cmd_properties(args) -> int:
    """apps/tools graph properties: n, m, weights, degree stats."""
    g = _load(args.graph, args.format)
    deg = g.degrees()
    print(f"n={g.n} m={g.m // 2} (directed {g.m})")
    print(
        f"node_weighted={g.is_node_weighted()} edge_weighted={g.is_edge_weighted()}"
    )
    print(f"total_node_weight={g.total_node_weight}")
    print(f"total_edge_weight={g.total_edge_weight}")
    if g.n:
        print(
            f"degree min={int(deg.min())} max={int(deg.max())} "
            f"avg={float(deg.mean()):.2f}"
        )
    print(f"isolated_nodes={count_isolated_nodes(g)}")
    return 0


def cmd_partition_properties(args) -> int:
    """apps/tools partition properties: cut, imbalance, block weights."""
    g = _load(args.graph, args.format)
    part = io_mod.read_partition(args.partition)
    if len(part) != g.n:
        print(f"error: partition has {len(part)} entries, graph {g.n} nodes",
              file=sys.stderr)
        return 1
    from .graphs.host import host_partition_metrics

    k = int(part.max()) + 1 if len(part) else 0
    m = host_partition_metrics(g, part, k)
    bw = m["block_weights"]
    print(f"k={k} cut={m['cut']}")
    print(f"imbalance={m['imbalance']:.6f}")
    print(f"block_weights min={int(bw.min())} max={int(bw.max())}")
    return 0


def cmd_compress(args) -> int:
    """apps/tools graph compression: write the compressed container."""
    from .graphs.compressed import compress_host_graph

    g = _load(args.graph, args.format)
    cg = compress_host_graph(g)
    io_mod.write_compressed(args.output, cg)
    print(
        f"compressed {args.graph} -> {args.output} "
        f"(ratio {cg.compression_ratio():.2f}x, {cg.memory_bytes()} bytes)"
    )
    return 0


def cmd_decompress(args) -> int:
    g = _load(args.graph, "compressed")
    io_mod.write_metis(g, args.output)
    print(f"decompressed {args.graph} -> {args.output}")
    return 0


def cmd_rearrange(args) -> int:
    """apps/tools rearrangement: degree-bucket node order
    (graphutils/permutator.h rearrange_by_degree_buckets)."""
    g = _load(args.graph, args.format)
    perm = degree_bucket_permutation(g)
    out = apply_permutation(g, perm)
    io_mod.write_metis(out, args.output)
    print(f"rearranged {args.graph} -> {args.output}")
    return 0


def cmd_components(args) -> int:
    """Connected components via the device kernel (ops/components.py)."""
    from .graphs.csr import device_graph_from_host
    from .ops.components import connected_components

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (the tool's --device cpu)", file=sys.stderr)
        return 1
    g = _load(args.graph, args.format)
    dg = device_graph_from_host(g, device)
    labels = connected_components(dg)[: g.n].cpu().numpy()
    comps, sizes = np.unique(labels, return_counts=True)
    print(f"components={len(comps)}")
    if len(comps):
        print(f"largest={int(sizes.max())} smallest={int(sizes.min())}")
    if args.output:
        io_mod.write_partition(args.output, np.searchsorted(comps, labels))
    return 0


def cmd_convert(args) -> int:
    g = _load(args.graph, args.format)
    if args.output.endswith(".parhip") or args.to == "parhip":
        io_mod.write_parhip(g, args.output)
    else:
        io_mod.write_metis(g, args.output)
    print(f"converted {args.graph} -> {args.output}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="kaminpar_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, output=False, required_output=False):
        sp.add_argument("graph")
        sp.add_argument("-f", "--format", default="auto")
        if output:
            sp.add_argument(
                "-o", "--output", required=required_output, default=None
            )

    common(sub.add_parser("properties"))
    spp = sub.add_parser("partition-properties")
    common(spp)
    spp.add_argument("partition")
    common(sub.add_parser("compress"), output=True, required_output=True)
    common(sub.add_parser("decompress"), output=True, required_output=True)
    common(sub.add_parser("rearrange"), output=True, required_output=True)
    sc = sub.add_parser("components")
    common(sc, output=True)
    sc.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where to run the kernel: the CUDA card (default; an error "
        "without one) or the CPU",
    )
    scv = sub.add_parser("convert")
    common(scv, output=True, required_output=True)
    scv.add_argument("--to", default=None, choices=[None, "metis", "parhip"])

    args = p.parse_args(argv)
    return {
        "properties": cmd_properties,
        "partition-properties": cmd_partition_properties,
        "compress": cmd_compress,
        "decompress": cmd_decompress,
        "rearrange": cmd_rearrange,
        "components": cmd_components,
        "convert": cmd_convert,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
