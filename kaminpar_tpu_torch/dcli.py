"""Distributed command line (counterpart of kaminpar_tpu/dcli.py, the
dKaMinPar binary analog, apps/dKaMinPar.cc).

``-n/--num-devices`` is the number of shards of the mesh, which one
process drives (parallel/mesh.py); ``--device`` picks where they run, the
card (``cuda``, the default) or the CPU.  Every flag of the JAX package's
dcli is here.  ``--comm-table`` prints this package's per-call collective
account.  ``--heartbeat-file``, ``--metrics-file`` (the per-call
collective bytes and calls among the metrics) and ``--trace-out`` work as
in the JAX dcli; the serving flags (``--serve-batch``,
``--serve-isolation``) and the shared-memory-only flags (``--scheme``,
``--delta-batch``, ``--dynamic-replicas``) exit 2 pointing at the shm CLI,
as in the JAX package.

Usage:  python -m kaminpar_tpu_torch.dcli GRAPH -k K [-n N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from . import io as io_mod
from .utils import timer
from .utils.logger import OutputLevel

def build_parser() -> argparse.ArgumentParser:
    from .parallel.dist_context import get_dist_preset_names

    p = argparse.ArgumentParser(
        prog="kaminpar_tpu_torch.dcli",
        description="distributed deep multilevel graph partitioner over a "
        "mesh of shards (dKaMinPar analog), PyTorch/CUDA",
    )
    p.add_argument(
        "graph", nargs="?",
        help="input graph file, or generator string "
        "'gen:rmat;n=65536;m=1000000;seed=1'",
    )
    p.add_argument("-k", "--k", type=int, default=None,
                   help="number of blocks")
    p.add_argument("-e", "--epsilon", type=float, default=None,
                   help="max imbalance, e.g. 0.03 (default)")
    p.add_argument("-P", "--preset", default="default",
                   choices=sorted(get_dist_preset_names()),
                   help="distributed configuration preset")
    p.add_argument("-n", "--num-devices", type=int, default=None,
                   help="number of shards (default: one per device)")
    p.add_argument("--device", default="cuda",
                   help="where the shards run: cuda (default) or cpu")
    p.add_argument("-s", "--seed", type=int, default=0, help="RNG seed")
    p.add_argument(
        "--stream-chunks", type=int, default=0, metavar="N",
        help="generate a 'gen:' input in N streaming chunks "
        "(chunking-invariant output; rmat/gnm/rgg2d only)",
    )
    p.add_argument("-f", "--format", default="auto",
                   choices=["auto", "metis", "parhip", "compressed"],
                   help="input graph format")
    p.add_argument("-o", "--output", default=None,
                   help="partition output file")
    p.add_argument("-q", "--quiet", action="store_true", help="no output")
    p.add_argument("--validate", action="store_true",
                   help="validate the input graph before partitioning")
    p.add_argument("-T", "--timers", action="store_true",
                   help="print the timer tree")
    p.add_argument("--machine-timers", action="store_true",
                   help="print the timer tree as one machine-readable line")
    p.add_argument(
        "--comm-table", action="store_true",
        help="print the per-phase collective account (per call: phase, "
        "collective, payload shape, calls, payload bytes per device)",
    )
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="write pipeline-barrier checkpoints under DIR")
    p.add_argument(
        "--resume", action="store_true",
        help="resume from --checkpoint-dir at the recorded dist barrier (a "
        "changed graph, config or shard count restarts clean)",
    )
    p.add_argument("--time-budget", type=float, default=None,
                   metavar="SECS",
                   help="anytime mode: wind down at the next barrier once "
                   "SECS have elapsed")
    p.add_argument("--budget-grace", type=float, default=None,
                   metavar="SECS",
                   help="declared wind-down allowance on top of "
                   "--time-budget (default 30)")
    p.add_argument(
        "--memory-budget", type=float, default=None, metavar="BYTES",
        help="declared per-device memory budget (or "
        "KAMINPAR_TPU_HBM_BYTES): priced on the heaviest shard; an OOM "
        "walks the agreed recovery ladder",
    )
    p.add_argument(
        "--lp-rating", default=None,
        choices=["auto", "scatter", "sort", "hash", "dense"],
        help="dist LP rating engine (auto: dense/sort; scatter for "
        "skewed graphs; sort2 needs CSR row spans and is shm-only)",
    )
    p.add_argument("--serve-batch", default=None, metavar="BATCH.json",
                   help="serve/batch mode runs on the shm CLI")
    p.add_argument("--scheme", default=None, choices=["external"],
                   help="the out-of-core scheme is served by the shm CLI")
    p.add_argument("--delta-batch", default=None, metavar="DELTAS.json",
                   help="dynamic repartitioning is served by the shm CLI")
    p.add_argument("--dynamic-replicas", type=int, default=None,
                   metavar="G",
                   help="the replica race belongs to the shm dynamic CLI")
    p.add_argument("--serve-isolation", default=None,
                   choices=["inproc", "process"],
                   help="supervised worker execution belongs to the shm "
                   "serving CLI")
    p.add_argument("--heartbeat-file", default=None, metavar="PATH",
                   help="touch PATH's mtime at every dist pipeline "
                   "barrier (and from the watchdog tick while nothing is "
                   "hung), so external supervisors can tell "
                   "slow-but-alive from hung")
    p.add_argument("--metrics-file", default=None, metavar="PATH",
                   help="export live metrics (per-phase collective bytes "
                   "and calls among them) to PATH in Prometheus text "
                   "format on a cadence (also via "
                   "KAMINPAR_TPU_METRICS_FILE)")
    from . import telemetry

    telemetry.add_cli_args(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.scheme is not None:
        print("error: --scheme external runs on the shm pipeline — use "
              "`python -m kaminpar_tpu_torch GRAPH -k K --scheme external`",
              file=sys.stderr)
        return 2
    if args.delta_batch is not None or args.dynamic_replicas is not None:
        print("error: dynamic repartitioning runs on the shm pipeline — "
              "use `python -m kaminpar_tpu_torch GRAPH -k K --delta-batch "
              "DELTAS.json [--dynamic-replicas G]`", file=sys.stderr)
        return 2
    if args.serve_batch is not None:
        print("error: serve/batch mode runs on the shm pipeline — use "
              "`python -m kaminpar_tpu_torch --serve-batch BATCH.json`",
              file=sys.stderr)
        return 2
    if args.serve_isolation is not None:
        print("error: supervised worker isolation is a serving-layer "
              "mode — use `python -m kaminpar_tpu_torch --serve-batch "
              "BATCH.json --serve-isolation process`", file=sys.stderr)
        return 2
    if args.heartbeat_file:
        from .resilience import supervisor as supervisor_mod

        supervisor_mod.set_heartbeat(args.heartbeat_file)
    from .telemetry import metrics as metrics_mod

    metrics_mod.configure(args.metrics_file)
    if args.graph is None:
        print("error: no graph file given", file=sys.stderr)
        return 1
    if args.k is None:
        print("error: need -k", file=sys.stderr)
        return 1
    from .device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (the dcli's --device cpu)", file=sys.stderr)
        return 1

    t_io = time.perf_counter()
    if args.graph.startswith("gen:"):
        if args.stream_chunks > 0:
            from .io.skagen import hostgraph_from_stream, streamed

            graph = hostgraph_from_stream(
                streamed(args.graph, num_chunks=args.stream_chunks))
        else:
            from .graphs.factories import generate

            graph = generate(args.graph)
    else:
        graph = io_mod.load_graph(args.graph, fmt=args.format)
    io_s = time.perf_counter() - t_io

    if args.validate:
        from .graphs.host import validate_graph

        validate_graph(graph)

    from . import telemetry
    from .parallel import dKaMinPar, make_mesh

    if args.diff_base and not args.report_json:
        print("error: --diff-base requires --report-json", file=sys.stderr)
        return 2
    telemetry.enable_if_requested(args)
    from .resilience import faults as faults_mod

    fault_plan = os.environ.get(faults_mod.ENV_VAR, "")
    if fault_plan:
        try:
            faults_mod.parse_plan(fault_plan)
        except faults_mod.FaultPlanError as e:
            print(f"error: bad {faults_mod.ENV_VAR}: {e}", file=sys.stderr)
            return 1
        if not args.quiet:
            print(f"FAULTS plan={fault_plan} (fault injection ACTIVE; "
                  "see the report's 'faults' section)")
    if args.resume and not args.checkpoint_dir:
        print("error: --resume requires --checkpoint-dir", file=sys.stderr)
        return 2
    mesh = make_mesh(args.num_devices, device=args.device)
    solver = dKaMinPar(args.preset, mesh=mesh)
    if args.lp_rating is not None:
        solver.ctx.lp_rating = args.lp_rating
    solver.set_graph(graph)
    if args.quiet:
        solver.set_output_level(OutputLevel.QUIET)

    from .resilience import deadline as deadline_mod

    deadline_mod.install_signal_handlers()
    res_ctx = solver.ctx.shm.resilience
    if args.checkpoint_dir:
        res_ctx.checkpoint_dir = args.checkpoint_dir
    if args.resume:
        res_ctx.resume = True
    if args.time_budget is not None:
        res_ctx.time_budget = args.time_budget
    if args.budget_grace is not None:
        res_ctx.budget_grace = args.budget_grace
    if args.memory_budget is not None:
        res_ctx.memory_budget = args.memory_budget

    t0 = time.perf_counter()
    try:
        partition = solver.compute_partition(k=args.k, epsilon=args.epsilon,
                                             seed=args.seed)
    except KeyboardInterrupt:
        from .cli import _emergency_interrupt_exit

        return _emergency_interrupt_exit(args, t0)
    wall = time.perf_counter() - t0

    if not args.quiet:
        print(f"TIME io={io_s:.3f}s partitioning={wall:.3f}s")
        if args.timers:
            print(timer.render_aggregated(timer.aggregate_across_processes()))
        if args.machine_timers:
            print("TIMERS " + timer.GLOBAL_TIMER.render_machine())
        if args.comm_table:
            from .parallel.mesh import comm_table

            print(comm_table())

    rc = telemetry.export_cli_outputs(
        args,
        extra_run={"io_seconds": round(io_s, 3),
                   "partition_seconds": round(wall, 3)},
        quiet=args.quiet,
    )
    if args.output:
        io_mod.write_partition(args.output, partition)
    return rc


if __name__ == "__main__":
    sys.exit(main())
