#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload rmat-k16 --seed 7 --seconds 30 --trace 0

Set-up (timed as `setup_s`, from the start of this script): the imports,
the cell's graph drawn on the card from --seed and copied to the host as a
CSR, and one warm partition at the cell's full size.  The window then calls
`KaMinPar(preset).set_graph(graph).compute_partition(k, epsilon, seed)`
back to back, a fresh partition seed per call, until --seconds have passed
(the last call runs to its end).  After the window, every partition it
returned is recounted by the plain reference (reference/partition.py) and
held to the cell's limits; the numbers compared and their limits end
standard error and close the result line, the last line of standard output.

--trace 1 reports the cell's per-layer metrics instead of its end-to-end
ones: the phase walls from the window's partitions, then one partition
under the host-sync census (census.py) and one under torch.profiler
(profiling.py), each a partition of its own.

Exits non-zero without a result when no CUDA card is visible, when the
program cannot be imported, and when JAX or the JAX package is loaded in
this process once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# One process with few host threads: the port's host work is one Python
# thread with NumPy beside it, and idle pool threads only meet the
# machine's other load.  Set before NumPy and torch are imported.
HOST_THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

from portbench import cells, machine  # noqa: E402
from portbench.reference import partition as reference  # noqa: E402

GIB = float(1 << 30)
TRACE_DEADLINE_S = 300.0


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def partition_seed(seed: int, i: int) -> int:
    """The seed of the run's i-th partition (0: the warm one), in [0, 2^31)."""
    return (seed * 2654435761 + 40503 * (i + 1)) % 2147483647


class Card:
    """The device calls the harness makes, as no-ops on the CPU (the CPU is
    used by the tests only)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if self.cuda:
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0


class Session:
    """The cell's graph and one facade that partitions it."""

    def __init__(self, spec: dict, seed: int, card: Card):
        import kaminpar_tpu_torch as kp

        from portbench import graph

        self.spec = spec
        self.card = card
        self.package_dir = str(Path(kp.__file__).resolve().parent)
        self.xadj, self.adjncy = graph.make(spec["config"], seed, card.device)
        traffic = spec["traffic"]
        self.k = int(traffic["k"])
        self.epsilon = float(traffic["epsilon"])
        self.solver = kp.KaMinPar(traffic["preset"], device=card.device)
        self.solver.set_output_level(0)
        self.solver.set_graph(kp.HostGraph(self.xadj, self.adjncy))

    def partition(self, seed: int):
        part = self.solver.compute_partition(
            k=self.k, epsilon=self.epsilon, seed=seed)
        self.card.sync()
        return part

    def reported_cut(self):
        """The cut the program reported for its last partition (its output
        gate's count), or None."""
        gate = self.solver.last_gate
        return None if not gate else gate.get("cut_recomputed")


def run_window(session: Session, seconds: float, seed: int) -> dict:
    """Partitions back to back until `seconds` have passed; each record
    holds the partition, its wall, phase walls, peak and reported cut."""
    card = session.card
    records = []
    start = time.perf_counter()
    end = start
    while True:
        i = len(records) + 1
        card.reset_peak()
        t0 = time.perf_counter()
        try:
            part, error = session.partition(partition_seed(seed, i)), None
        except Exception as exc:  # a call that raises fails; the run goes on
            traceback.print_exc()
            part, error = None, f"{type(exc).__name__}: {exc}"
        end = time.perf_counter()
        records.append({
            "seed": partition_seed(seed, i),
            "wall_s": end - t0,
            "timings": dict(session.solver.last_timings) if error is None else {},
            "peak_bytes": card.peak(),
            "reported_cut": session.reported_cut() if error is None else None,
            "part": part,
            "error": error,
        })
        if end - start >= seconds:
            break
    return {"records": records, "seconds": end - start}


def judge(session: Session, records: list, limits: dict) -> dict:
    """Recount every partition with the reference and compare the run's
    numbers with the cell's limits: per partition, labels out of range, the
    overload and the gap to the reported cut (the worst of each); per run,
    the mean cut share.  Returns {"failed", "checks", "cut_frac"}; a check
    is {"value", "limit"} and holds when value <= limit."""
    n = len(session.xadj) - 1
    failed = 0
    worst = {"out_of_range": 0, "overload": None, "cut_gap": 0}
    fracs = []
    for rec in records:
        if rec["error"] is not None:
            failed += 1
            continue
        counted = reference.recount(session.xadj, session.adjncy,
                                    rec["part"], session.k)
        v = reference.judge(counted, session.k, session.epsilon, n,
                            rec["reported_cut"])
        rec["judged"] = v
        bad = (v["out_of_range"] > limits["out_of_range"]
               or v["overload"] > limits["overload"]
               or v["cut_gap"] > limits["cut_gap"]
               or v["cut_frac"] is None)
        failed += int(bad)
        worst["out_of_range"] += v["out_of_range"]
        worst["overload"] = (v["overload"] if worst["overload"] is None
                             else max(worst["overload"], v["overload"]))
        worst["cut_gap"] = max(worst["cut_gap"], v["cut_gap"])
        if v["cut_frac"] is not None:
            fracs.append(v["cut_frac"])
    mean = sum(fracs) / len(fracs) if fracs else None
    worst["cut_frac_mean"] = mean
    checks = {"failed": {"value": failed, "limit": limits["failed"]}}
    for name, value in worst.items():
        if value is not None:  # None: no partition came back, `failed` > 0
            checks[name] = {"value": value, "limit": limits[name]}
    return {"failed": failed, "checks": checks, "cut_frac": mean}


def end_to_end_metrics(setup_s, window, verdict, bench, cell_name) -> dict:
    records = window["records"]
    done = [r for r in records if r["error"] is None]
    values = {"setup_s": setup_s}
    if done:
        values["partition_s"] = window["seconds"] / len(done)
        values["peak_device_gib"] = max(r["peak_bytes"] for r in done) / GIB
    if verdict["cut_frac"] is not None:
        values["cut_frac"] = verdict["cut_frac"]
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cells.end_to_end(cell_name, bench) if m["name"] in values}


def per_layer_metrics(records: dict, bench, cell_name) -> dict:
    out = {}
    for name in cells.per_layer_names(cell_name, bench):
        module = cells.metric(name)
        value = module.read(records)
        if value is not None:
            out[name] = {"value": float(value), "unit": module.UNIT}
    return out


def emit(result: dict) -> None:
    """The numbers compared, as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, check in result["checks"].items():
        print(f"portbench check {name}: {check['value']} "
              f"(limit: at most {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None, device: str = "cuda") -> int:
    args = parse_args(argv)
    bench = cells.manifest()
    spec = cells.cell(args.workload)
    chips = int(spec.get("chips", 1))
    import torch

    torch.set_num_threads(HOST_THREADS)
    if device == "cuda":
        machine.require_cards(torch, chips)
    card = Card(torch, device)
    session = Session(spec, args.seed, card)
    session.partition(partition_seed(args.seed, 0))
    setup_s = time.perf_counter() - T0
    print(f"portbench: {args.workload} seed {args.seed}: n={len(session.xadj) - 1} "
          f"m={len(session.adjncy)} set-up {setup_s:.3f} s", file=sys.stderr)

    gc.freeze()  # set-up's objects stay out of the window's collections
    window = run_window(session, args.seconds, args.seed)
    gc.unfreeze()
    records = window["records"]
    for r in records:
        print(f"portbench: partition seed {r['seed']}: {r['wall_s']:.3f} s "
              f"peak {r['peak_bytes']} B timings "
              f"{json.dumps(r['timings'])} error {r['error']}", file=sys.stderr)
    peak = max((r["peak_bytes"] for r in records), default=0)
    dev = machine.device_entry(torch, chips, peak) if card.cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1,
        "memory_peak_bytes": peak}

    traced = None
    if args.trace:
        from portbench import census, profiling

        _, syncs = census.count_syncs(
            lambda: session.partition(partition_seed(args.seed, 10_001)),
            torch, session.package_dir)
        _, profile = profiling.profile_call(
            lambda: session.partition(partition_seed(args.seed, 10_002)),
            torch, deadline=T0 + TRACE_DEADLINE_S)
        traced = {"window": [r for r in records if r["error"] is None],
                  "census": syncs, "profile": profile}
        print(f"portbench: census {json.dumps(syncs)}", file=sys.stderr)

    session.solver = None  # the program's state is freed before the recount
    verdict = judge(session, records, spec["limits"])
    if traced is None:
        metrics = end_to_end_metrics(setup_s, window, verdict, bench,
                                     args.workload)
    else:
        metrics = per_layer_metrics(traced, bench, args.workload)
        if traced["profile"] is not None:
            dev["busy_s"] = traced["profile"]["busy_s"]
            dev["window_s"] = traced["profile"]["window_s"]

    found = machine.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for c in verdict["checks"].values())
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if traced is not None and traced["profile"] is not None:
        result["breakdown"] = {
            "device_ops": traced["profile"]["device_ops"],
            "idle_gaps": traced["profile"]["idle_gaps"]}
    result["checks"] = verdict["checks"]
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
