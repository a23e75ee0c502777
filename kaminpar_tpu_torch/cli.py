"""Command line of the port (own copy of kaminpar_tpu/cli.py; analog of
apps/KaMinPar.cc:405 main and kaminpar-cli/kaminpar_arguments.cc).

The flags map onto the Context tree as the JAX package's do: preset
selection, partition parameters (k, epsilon, explicit block weights,
minimum block weights), algorithm overrides, input formats and ``gen:``
generator specs, node ordering, seed, output files, timers, statistics
and the heap profile, debug dumps, checkpoints and resume, the anytime
budget, the memory budget, the out-of-core scheme and dynamic delta
chains (``--delta-batch``), and TOML config round-tripping (``-C`` in,
``--dump-config`` out; a file dumped by either package loads in the
other).  For the same input, flags and seed the written partition is the
JAX package's, bitwise.

``--device`` picks where the partition is computed, the card (``cuda``,
the default) or the CPU; without a card, ``cuda`` exits with an error.
``--serve-batch`` serves a JSON batch of requests through the
PartitionService (serving/), in this process or, with
``--serve-isolation process``, in a supervised worker on the same
device; ``--heartbeat-file``, ``--metrics-file`` and ``--trace-out`` (and
``KAMINPAR_TPU_HEARTBEAT_FILE`` / ``KAMINPAR_TPU_METRICS_FILE``) work as
in the JAX CLI.

Usage:  python -m kaminpar_tpu_torch <graph> -k 16 [-P preset] [options]
        python -m kaminpar_tpu_torch --serve-batch BATCH.json [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import io as io_mod
from .context import (
    Context,
    PartitioningMode,
    RefinementAlgorithm,
    context_to_dict,
)
from .device import resolve_device
from .kaminpar import KaMinPar
from .presets import create_context_by_preset_name, get_preset_names
from .utils import timer
from .utils.logger import OutputLevel

# ---------------------------------------------------------------------------
# Context <-> plain dict (for -C config files and --dump-config)
# ---------------------------------------------------------------------------


def apply_dict_to_context(ctx: Any, data: Dict[str, Any]) -> None:
    """Overlay a (possibly partial) nested dict onto the dataclass tree."""
    for key, value in data.items():
        if not hasattr(ctx, key):
            raise ValueError(f"unknown config key: {key!r}")
        current = getattr(ctx, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            apply_dict_to_context(current, value)
        elif isinstance(current, enum.Enum):
            setattr(ctx, key, type(current)(value))
        elif isinstance(current, list) and current and isinstance(
            current[0], enum.Enum
        ):
            setattr(ctx, key, [type(current[0])(v) for v in value])
        elif key == "algorithms":  # empty refiner list: elements are enums
            setattr(ctx, key, [RefinementAlgorithm(v) for v in value])
        elif value == "inf":
            setattr(ctx, key, float("inf"))
        else:
            setattr(ctx, key, type(current)(value) if current is not None else value)


def dump_toml(data: Dict[str, Any], prefix: str = "") -> List[str]:
    """Minimal TOML emitter for the context dict (scalars, lists, tables)."""
    lines: List[str] = []
    scalars = {k: v for k, v in data.items() if not isinstance(v, dict)}
    tables = {k: v for k, v in data.items() if isinstance(v, dict)}
    for k, v in scalars.items():
        if v is None:
            continue
        if isinstance(v, bool):
            lines.append(f"{k} = {'true' if v else 'false'}")
        elif isinstance(v, (int, float)):
            lines.append(f"{k} = {v}")
        elif isinstance(v, str):
            lines.append(f'{k} = "{v}"')
        elif isinstance(v, list):
            items = ", ".join(
                f'"{x}"' if isinstance(x, str) else str(x) for x in v
            )
            lines.append(f"{k} = [{items}]")
    for k, v in tables.items():
        name = f"{prefix}.{k}" if prefix else k
        lines.append("")
        lines.append(f"[{name}]")
        lines.extend(dump_toml(v, name))
    return lines


# ---------------------------------------------------------------------------
# Argument parser (kaminpar_arguments.cc flag groups)
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaminpar_tpu_torch",
        description="Deep multilevel graph partitioner (PyTorch/CUDA port)",
    )
    p.add_argument("graph", nargs="?", help="input graph file")
    p.add_argument("-k", "--k", type=int, default=None, help="number of blocks")
    p.add_argument(
        "-e", "--epsilon", type=float, default=None,
        help="max imbalance, e.g. 0.03 (default)",
    )
    p.add_argument(
        "-B", "--max-block-weights", type=int, nargs="+", default=None,
        help="explicit per-block max weights (overrides -k/-e)",
    )
    p.add_argument(
        "--min-epsilon", type=float, default=None,
        help="enforce min block weights (1-eps)*perfect",
    )
    p.add_argument(
        "-P", "--preset", default="default",
        choices=sorted(get_preset_names()), help="configuration preset",
    )
    p.add_argument("-C", "--config", default=None, help="TOML config file")
    p.add_argument(
        "--dump-config", action="store_true",
        help="print the effective config as TOML and exit",
    )
    p.add_argument("-s", "--seed", type=int, default=None, help="RNG seed")
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where to partition: the CUDA card (default; an error "
        "without one) or the CPU",
    )
    p.add_argument(
        "-f", "--format", default="auto",
        choices=["auto", "metis", "parhip", "compressed"],
        help="input graph format",
    )
    p.add_argument(
        "--node-ordering", default="natural",
        choices=["natural", "degree-buckets"],
        help="node ordering applied after loading (NodeOrdering analog)",
    )
    p.add_argument("-o", "--output", default=None, help="partition output file")
    p.add_argument(
        "--output-block-sizes", default=None, help="block size output file"
    )
    p.add_argument(
        "--output-remapping", default=None,
        help="write the node remapping applied by --node-ordering "
        "(write_remapping analog)",
    )
    p.add_argument("-q", "--quiet", action="store_true", help="no output")
    p.add_argument(
        "--validate", action="store_true",
        help="validate the input graph (graph_validator analog)",
    )
    p.add_argument(
        "--no-repair", action="store_true",
        help="disable the output gate's greedy balance-repair pass "
        "(the strict-balance check still runs and reports violations; "
        "see docs/robustness.md)",
    )
    p.add_argument(
        "--checkpoint-dir", default=None, metavar="DIR",
        help="write atomic pipeline-barrier checkpoints (versioned, "
        "checksummed manifest) under DIR; a preempted run can then "
        "--resume without re-running completed levels "
        "(docs/robustness.md)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="re-enter the pipeline at the stage recorded in "
        "--checkpoint-dir (graph + config fingerprints must match, "
        "else a clean restart); requires --checkpoint-dir",
    )
    p.add_argument(
        "--time-budget", type=float, default=None, metavar="SECS",
        help="anytime mode: wind down at the next pipeline barrier once "
        "SECS of partitioning have elapsed and return the best "
        "gate-valid partition reached (report annotated anytime: true)",
    )
    p.add_argument(
        "--budget-grace", type=float, default=None, metavar="SECS",
        help="declared wind-down allowance on top of --time-budget for "
        "the mandatory tail (extension, gate/repair, final checkpoint; "
        "default 30).  Advisory: reported in the anytime section so "
        "operators can size preemption windows; the tail is not "
        "forcibly interrupted",
    )
    p.add_argument(
        "--memory-budget", type=float, default=None, metavar="BYTES",
        help="declared device-memory budget (bytes; also readable from "
        "KAMINPAR_TPU_HBM_BYTES): the run either fits it or degrades "
        "through the memory governor's recovery ladder (tight pads -> "
        "host-spilled hierarchy -> semi-external streaming -> "
        "host-only) — never RESOURCE_EXHAUSTED (docs/robustness.md)",
    )
    p.add_argument(
        "--delta-batch", default=None, metavar="DELTAS.json",
        help="dynamic repartitioning (kaminpar_tpu_torch/dynamic/): apply "
        "the JSON delta chain (edge inserts/deletes, vertex add/remove, "
        "weight updates) to the positional graph step by step; each "
        "step gets a warm-started v-cycle repartition (or a cold run "
        "when the drift estimator says warm-starting would lose) and "
        "the telemetry.diff cut gate asserts stability across deltas.  "
        "Per-step DYNAMIC lines on stdout, the `dynamic` report "
        "section in --report-json; works with --checkpoint-dir/"
        "--resume (mid-chain kill-and-resume restores the session "
        "cut-identically; docs/robustness.md)",
    )
    p.add_argument(
        "--dynamic-replicas", type=int, default=None, metavar="G",
        help="delta-batch mode: race the warm v-cycle against G-1 cold "
        "replicas per step and keep the better cut (PASCO-style "
        "replicated repartitioning; default 1 = drift decision only)",
    )
    p.add_argument(
        "--serve-batch", default=None, metavar="BATCH.json",
        help="serve/batch mode (partitioning-as-a-service): run every "
        "request in the JSON batch spec through the admission-"
        "controlled PartitionService — per-request fault isolation, "
        "bounded result cache, per-request deadlines, SIGTERM drain; "
        "verdicts land in the report's `serving` section "
        "(docs/robustness.md).  The positional graph and -k are not "
        "used in this mode",
    )
    p.add_argument(
        "--serve-queue-depth", type=int, default=None, metavar="N",
        help="serve mode: admission queue-depth cap (default 64; "
        "overload is rejected, never queued unboundedly)",
    )
    p.add_argument(
        "--serve-cost-cap", type=float, default=None, metavar="BYTES",
        help="serve mode: total estimated-cost admission cap across "
        "queued requests, in bytes of estimated device footprint (the "
        "memory governor's sizing model, resilience/memory.py; "
        "default 8 GiB)",
    )
    p.add_argument(
        "--serve-isolation", default=None,
        choices=["inproc", "process"],
        help="serve mode: execution isolation (default inproc). "
        "`process` runs every request's compute in a supervised worker "
        "subprocess (resilience/supervisor.py): a worker hung past its "
        "hard wall-clock ceiling is SIGKILLed (verdict "
        "failed/worker-hang), a worker segfault/OOM-kill is classified "
        "(failed/worker-crash), and the service keeps draining the "
        "queue; workers are warm-reused and recycled on request-count "
        "or RSS watermarks (docs/robustness.md, supervision contract)",
    )
    p.add_argument(
        "--heartbeat-file", default=None, metavar="PATH",
        help="touch PATH's mtime at every pipeline barrier and from "
        "the watchdog tick while nothing is hung, so external "
        "supervisors (k8s liveness probes, systemd WatchdogSec) can "
        "tell slow-but-alive from hung without parsing output (also "
        "via KAMINPAR_TPU_HEARTBEAT_FILE; docs/robustness.md)",
    )
    p.add_argument(
        "--metrics-file", default=None, metavar="PATH",
        help="export live metrics (request verdicts, rps, queue depth, "
        "cache hit rate, comm bytes) to PATH in Prometheus text "
        "format, rewritten atomically on a cadence (also via "
        "KAMINPAR_TPU_METRICS_FILE; docs/observability.md)",
    )
    p.add_argument(
        "-T", "--timers", action="store_true", help="print the timer tree"
    )
    p.add_argument(
        "--machine-timers", action="store_true",
        help="print the timer tree as one machine-readable line",
    )
    p.add_argument(
        "-H", "--heap-profile", action="store_true",
        help="profile host/device memory per phase (heap_profiler analog)",
    )
    p.add_argument(
        "--statistics", action="store_true",
        help="collect and print detailed statistics (IFSTATS analog)",
    )
    from . import telemetry

    telemetry.add_cli_args(p)
    p.add_argument(
        "-m", "--mode", default=None,
        choices=[m.value for m in PartitioningMode],
        help="partitioning scheme override",
    )
    p.add_argument(
        "--scheme", dest="mode",
        choices=[m.value for m in PartitioningMode],
        help="alias of --mode; `--scheme external` runs the out-of-core "
        "streaming partitioner (kaminpar_tpu_torch/external/): the fine "
        "graph stays host/disk-resident in chunks (gen: specs are "
        "regenerated "
        "chunk-by-chunk and never materialized), LP + contraction "
        "stream padded edge blocks through the device, and only coarse "
        "levels are ever device-resident (docs/performance.md)",
    )
    p.add_argument(
        "--external-chunk-edges", type=int, default=None, metavar="M",
        help="external scheme: target edges per streamed chunk (default "
        "2^22; shrunk automatically to fit --memory-budget)",
    )
    p.add_argument(
        "--external-spill-dir", default=None, metavar="DIR",
        help="external scheme: spill decoded fine-level chunks to DIR "
        "once and re-read them per pass (fine graphs bigger than host "
        "RAM stream from disk)",
    )
    # common algorithm overrides (kaminpar_arguments.cc coarsening/refinement)
    p.add_argument("--lp-iterations", type=int, default=None)
    p.add_argument(
        "--lp-rating", default=None,
        choices=["auto", "scatter", "sort2", "sort", "hash", "dense"],
        help="LP rating engine (default auto: per-level density-adaptive "
        "selection; see ops/rating.py and docs/performance.md)",
    )
    p.add_argument(
        "--lp-rating-slots", type=int, default=None,
        help="hashed slots per node row for the scatter/hash engines",
    )
    p.add_argument("--contraction-limit", type=int, default=None)
    p.add_argument(
        "--refinement", default=None,
        help="semicolon-separated refiner list, e.g. "
        "'overload-balancer;lp;underload-balancer'",
    )
    p.add_argument(
        "--vcycles", type=int, nargs="+", default=None,
        help="block counts per v-cycle (vcycle mode)",
    )
    # debug dumps (kaminpar_arguments.cc debug group / DebugContext flags)
    p.add_argument(
        "--debug-dump", nargs="+", default=None, metavar="WHAT",
        choices=[
            "toplevel-graph", "toplevel-partition", "coarsest-graph",
            "coarsest-partition", "graph-hierarchy", "partition-hierarchy",
        ],
        help="write hierarchy dumps (debug.cc analog)",
    )
    p.add_argument(
        "--debug-dump-dir", default=None, help="directory for debug dumps"
    )
    return p


def make_context(args: argparse.Namespace) -> Context:
    ctx = create_context_by_preset_name(args.preset)
    if args.config:
        import tomllib

        with open(args.config, "rb") as f:
            apply_dict_to_context(ctx, tomllib.load(f))
    if args.mode:
        ctx.partitioning.mode = PartitioningMode(args.mode)
    if args.lp_iterations is not None:
        ctx.coarsening.clustering.lp.num_iterations = args.lp_iterations
    if args.lp_rating is not None:
        ctx.coarsening.clustering.lp.rating = args.lp_rating
    if args.lp_rating_slots is not None:
        ctx.coarsening.clustering.lp.rating_slots = args.lp_rating_slots
    if args.contraction_limit is not None:
        ctx.coarsening.contraction_limit = args.contraction_limit
    if args.refinement is not None:
        ctx.refinement.algorithms = [
            RefinementAlgorithm(a) for a in args.refinement.split(";") if a
        ]
    if args.vcycles is not None:
        ctx.partitioning.vcycles = list(args.vcycles)
    if args.debug_dump:
        for what in args.debug_dump:
            setattr(ctx.debug, "dump_" + what.replace("-", "_"), True)
    if args.debug_dump_dir:
        ctx.debug.dump_dir = args.debug_dump_dir
    if args.no_repair:
        ctx.resilience.repair = False
    if args.checkpoint_dir:
        ctx.resilience.checkpoint_dir = args.checkpoint_dir
    if args.resume:
        ctx.resilience.resume = True
    if args.time_budget is not None:
        ctx.resilience.time_budget = args.time_budget
    if args.budget_grace is not None:
        ctx.resilience.budget_grace = args.budget_grace
    if args.memory_budget is not None:
        ctx.resilience.memory_budget = args.memory_budget
    if args.external_chunk_edges is not None:
        ctx.external.chunk_edges = args.external_chunk_edges
    if args.external_spill_dir is not None:
        ctx.external.spill_dir = args.external_spill_dir
    if getattr(args, "dynamic_replicas", None) is not None:
        ctx.dynamic.replicas = int(args.dynamic_replicas)
    if args.seed is not None:  # -C config may set the seed; flag wins
        ctx.seed = args.seed
    return ctx


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    ctx = make_context(args)

    if args.dump_config:
        print("\n".join(dump_toml(context_to_dict(ctx))))
        return 0

    if args.serve_batch is None:
        if args.graph is None:
            print("error: no graph file given", file=sys.stderr)
            return 1
        if args.k is None and args.max_block_weights is None:
            print("error: need -k or -B/--max-block-weights",
                  file=sys.stderr)
            return 1
    if args.delta_batch is not None:
        if args.serve_batch is not None:
            print("error: --delta-batch and --serve-batch are mutually "
                  "exclusive (session requests inside a batch spec "
                  "cover the serve-mode story)", file=sys.stderr)
            return 2
        if args.k is None:
            print("error: --delta-batch needs -k", file=sys.stderr)
            return 2
        if args.node_ordering != "natural":
            print("error: --delta-batch needs natural node ordering "
                  "(delta vertex ids refer to file order; a "
                  "permutation would silently remap them)",
                  file=sys.stderr)
            return 2
        if args.output_remapping:
            print("error: --output-remapping is not supported with "
                  "--delta-batch (vertex add/remove deltas change the "
                  "node set, so no input-file-indexed remapping "
                  "exists; the partition output is indexed by the "
                  "FINAL node set)", file=sys.stderr)
            return 2
    if args.resume and not args.checkpoint_dir:
        print("error: --resume requires --checkpoint-dir", file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (the CLI's --device cpu)", file=sys.stderr)
        return 1

    # preemption routing (resilience/deadline.py): SIGTERM/SIGINT wind
    # the pipeline down at its next barrier and still produce a valid
    # partition + final checkpoint; a second signal forces the classic
    # behavior (handled by the emergency path below)
    from .resilience import deadline as deadline_mod

    deadline_mod.install_signal_handlers()

    # liveness heartbeat (resilience/supervisor.py): configured before
    # any long-running work so the first barrier already advances the
    # file external supervisors watch
    if args.heartbeat_file:
        from .resilience import supervisor as supervisor_mod

        supervisor_mod.set_heartbeat(args.heartbeat_file)

    # live metrics export (telemetry/metrics.py): armed before the run so
    # the cadence thread publishes scrapes while work is in flight (also
    # from KAMINPAR_TPU_METRICS_FILE; dormant when neither names a file)
    from .telemetry import metrics as metrics_mod

    metrics_mod.configure(args.metrics_file)

    from . import telemetry
    from .utils import heap_profiler, statistics

    if args.diff_base and not args.report_json:
        # fail BEFORE the (possibly long) run, like the fault-plan echo:
        # the user asked for a regression gate that could never fire
        print("error: --diff-base requires --report-json", file=sys.stderr)
        return 2

    if args.heap_profile:
        heap_profiler.enable()
    if args.statistics:
        statistics.enable()
    telemetry.enable_if_requested(args)

    # fault-plan echo: an active injection plan changes every result —
    # it must be impossible to mistake a chaos run for a clean one (the
    # run report carries the same plan in its `faults` section).  The
    # plan is parsed HERE so a typo fails at startup with a clear
    # message, not minutes in at the first registered site.
    from .resilience import faults as faults_mod

    fault_plan = os.environ.get(faults_mod.ENV_VAR, "")
    if fault_plan:
        try:
            faults_mod.parse_plan(fault_plan)
        except faults_mod.FaultPlanError as e:
            print(f"error: bad {faults_mod.ENV_VAR}: {e}", file=sys.stderr)
            return 1
        if not args.quiet:
            print(
                f"FAULTS plan={fault_plan} (fault injection ACTIVE; "
                "see the report's 'faults' section)"
            )

    if args.serve_batch is not None:
        # serve/batch mode: the serving layer owns the request loop
        # (admission, isolation, caching, drain) and the report export;
        # the signal handlers above make SIGTERM/SIGINT drain the queue
        from .serving.batch import run_batch_cli

        return run_batch_cli(args, ctx)

    t_io = time.perf_counter()
    external_mode = ctx.partitioning.mode == PartitioningMode.EXTERNAL
    if args.graph.startswith("gen:"):
        # synthetic input, KaGen option-string style (the dKaMinPar CLI's
        # -G generator surface, kaminpar-io/dist_skagen.h):
        #   gen:rmat;n=65536;m=1000000;seed=1
        graph = None
        if external_mode:
            # the external scheme streams generator specs: skagen chunk
            # regeneration means the synthetic fine graph is NEVER
            # materialized (generators with no streaming form fall back
            # to the in-RAM build below and stream from host CSR)
            from .external.chunkstore import StreamedSpecGraph

            try:
                graph = StreamedSpecGraph(
                    args.graph, target_edges=ctx.external.chunk_edges
                )
            except ValueError:
                graph = None
        if graph is None:
            from .graphs.factories import generate

            graph = generate(args.graph)
    else:
        graph = io_mod.load_graph(
            args.graph, fmt=args.format,
            # disk-backed fine graphs stream without a full-file RAM
            # spike: the external scheme asks for the lazy/mmap load of
            # compressed containers (io/compressed_binary.py)
            lazy=external_mode,
        )
    perm = None
    if args.node_ordering == "degree-buckets":
        from .external.chunkstore import StreamedSpecGraph
        from .graphs.compressed import CompressedHostGraph

        if isinstance(graph, (CompressedHostGraph, StreamedSpecGraph)):
            print(
                "error: --node-ordering is not supported for compressed "
                "containers or streamed generator specs",
                file=sys.stderr,
            )
            return 1
        from .graphs.host import (
            apply_permutation,
            degree_bucket_permutation,
        )

        perm = degree_bucket_permutation(graph)
        graph = apply_permutation(graph, perm)
    io_s = time.perf_counter() - t_io
    if not ctx.debug.graph_name:
        base = os.path.basename(args.graph)
        ctx.debug.graph_name = os.path.splitext(base)[0] or "graph"

    if args.delta_batch is not None:
        return _run_delta_chain(args, ctx, graph, io_s)

    partitioner = KaMinPar(ctx, device=args.device)
    if args.quiet:
        # instance-scoped: compute_partition applies and restores it
        partitioner.set_output_level(OutputLevel.QUIET)
    partitioner.set_graph(graph, validate=args.validate)

    if args.min_epsilon is not None:
        # needs k/weights set up first; compute_partition redoes setup,
        # so pre-setup here only to derive min weights
        ctx.partition.setup(graph, k=args.k, epsilon=args.epsilon,
                            max_block_weights=args.max_block_weights)
        ctx.partition.setup_min_block_weights(args.min_epsilon)

    t0 = time.perf_counter()
    try:
        partition = partitioner.compute_partition(
            k=args.k,
            epsilon=args.epsilon,
            max_block_weights=(
                np.asarray(args.max_block_weights, dtype=np.int64)
                if args.max_block_weights
                else None
            ),
            seed=args.seed,
        )
    except KeyboardInterrupt:
        # a forced interrupt (second SIGINT) can surface with timer
        # scopes still open; close them so the emergency run report
        # stays schema-valid, then write the requested report
        return _emergency_interrupt_exit(args, t0)
    wall = time.perf_counter() - t0

    if not args.quiet:
        # the JAX CLI's quality headline (telemetry/quality.py, printed
        # with telemetry on) waits for that module
        print(f"TIME io={io_s:.3f}s partitioning={wall:.3f}s")
    if args.timers and not args.quiet:
        print(timer.GLOBAL_TIMER.render())
    if args.machine_timers and not args.quiet:
        print("TIMERS " + timer.GLOBAL_TIMER.render_machine())
    if args.heap_profile and not args.quiet:
        print(heap_profiler.render())
    if args.statistics and not args.quiet:
        print(statistics.render())

    # non-zero when --diff-base found a regression against the baseline
    # report (telemetry/diff.py); output files are still written below
    rc = telemetry.export_cli_outputs(
        args,
        extra_run={"io_seconds": round(io_s, 3),
                   "partition_seconds": round(wall, 3)},
        quiet=args.quiet,
    )

    if perm is not None:
        # partition is indexed by reordered node ids; write in file order
        # (the permutation-aware output of kaminpar.cc:437-448)
        partition = partition[perm.old_to_new]
    if args.output_remapping:
        io_mod.write_remapping(
            args.output_remapping,
            perm.old_to_new if perm is not None
            else np.arange(graph.n, dtype=np.int64),  # natural = identity
        )
    if args.output:
        io_mod.write_partition(args.output, partition)
    if args.output_block_sizes:
        io_mod.write_block_sizes(
            args.output_block_sizes, partition, ctx.partition.k
        )
    return rc


def _run_delta_chain(args, ctx, graph, io_s: float) -> int:
    """``--delta-batch`` mode: drive the delta chain through the
    dynamic session driver (register -> per-delta mutate + warm/cold
    repartition), print per-step DYNAMIC lines, annotate the `dynamic`
    report section, and write the FINAL partition via the ordinary
    output flags."""
    from . import telemetry
    from .dynamic import load_delta_file, run_chain
    from .io.errors import GraphFormatError

    try:
        batches = load_delta_file(args.delta_batch)
    except GraphFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    def _cb(step: int, row: dict) -> None:
        if not args.quiet:
            print(
                "DYNAMIC step={} mode={} cut={} drift={} stable={} "
                "gate_valid={} wall={:.3f}s".format(
                    step, row.get("mode"), row.get("cut"),
                    row.get("drift"), row.get("stable"),
                    row.get("gate_valid"), row.get("wall_s", 0.0),
                )
            )

    t0 = time.perf_counter()
    try:
        partition, section = run_chain(
            graph, batches, ctx,
            k=int(args.k),
            # None keeps a -C config's epsilon, like the single-shot path
            epsilon=args.epsilon,
            seed=args.seed, quiet=bool(args.quiet), step_cb=_cb,
            device=args.device,
        )
    except KeyboardInterrupt:
        return _emergency_interrupt_exit(args, t0)
    except GraphFormatError as e:
        # a malformed delta (or a non-CSR input) is a data problem,
        # exactly like a malformed graph file in single-shot mode
        print(f"error: {e}", file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0

    # the stream belongs to the LAST step's run; the chain-level
    # sections ride on it (the serving layer's annotate-after idiom)
    telemetry.annotate(dynamic=section)
    if not args.quiet:
        counts = section.get("counts", {})
        print(
            "DYNAMIC-CHAIN steps={} warm={} cold={} replica={} "
            "in_place={} rebuilds={} final_cut={} wall={:.3f}s".format(
                len(section.get("decisions", [])),
                counts.get("warm", 0), counts.get("cold", 0),
                counts.get("replica", 0), counts.get("in_place", 0),
                counts.get("rebuilds", 0),
                (section.get("cut_trajectory") or [None])[-1], wall,
            )
        )
    rc = telemetry.export_cli_outputs(
        args,
        extra_run={"io_seconds": round(io_s, 3),
                   "delta_batch": args.delta_batch,
                   "delta_steps": len(batches),
                   "partition_seconds": round(wall, 3)},
        quiet=args.quiet,
    )
    if args.output:
        io_mod.write_partition(args.output, partition)
    if args.output_block_sizes:
        # args.k, not ctx.partition.k: a resumed chain may never run
        # ctx.partition.setup in this process (register fast-forwarded)
        io_mod.write_block_sizes(
            args.output_block_sizes, partition, int(args.k)
        )
    return rc


def _emergency_interrupt_exit(args, t0: float) -> int:
    """The hard-interrupt path: unwind open timer scopes (so that the
    emergency report's scope tree is whole), annotate the interruption,
    and export any requested report before exiting with the conventional
    130."""
    from . import telemetry
    from .resilience import deadline as deadline_mod

    closed = timer.GLOBAL_TIMER.unwind()
    if telemetry.enabled():
        anytime = {
            "anytime": True,
            "reason": "keyboard-interrupt",
            "elapsed_s": round(time.perf_counter() - t0, 3),
        }
        if deadline_mod.stage_reached():
            anytime["stage"] = deadline_mod.stage_reached()
        telemetry.annotate(anytime=anytime)
        if "result" not in telemetry.run_info():
            # no partition was produced; the schema-required result
            # section carries an explicit no-result sentinel (cut -1,
            # infeasible) rather than going missing — run.interrupted
            # marks the report for downstream consumers (telemetry.diff)
            telemetry.annotate(
                result={"cut": -1, "imbalance": 0.0, "feasible": False}
            )
        telemetry.export_cli_outputs(
            args,
            extra_run={"interrupted": True,
                       "partition_seconds": round(
                           time.perf_counter() - t0, 3)},
            quiet=args.quiet,
        )
    print(
        f"interrupted: {closed} open timer scope(s) closed"
        + (", emergency report written" if getattr(args, "report_json", None)
           else ""),
        file=sys.stderr,
    )
    return 130


if __name__ == "__main__":
    sys.exit(main())
