#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card, at a
cell's own size, in one process.

    python3 portbench/calibrate.py --workload rgg2d-k16 \\
        --seeds 11,12,13 --partitions 5 --kinds sound,control_2eps,fault_unrefined

For every seed, the cell's graph is drawn from it as a run draws it, and
each kind partitions it `--partitions` times with the seeds a run's window
gives its first partitions; the reference judges each as a run judges it.
The kinds:

- `sound`: the program as the cell runs it;
- `control_2eps`, the control, which breaks the balance the configuration
  states: the program partitions with twice the cell's epsilon, and the
  reference still holds it to the cell's epsilon;
- `fault_unrefined`, the fault "a step returns its state unchanged": the
  preset with its refiners (Jet, label propagation) taken out and its
  balancers kept, so every level keeps the partition it was handed, up to
  the moves that restore the balance.

Prints one JSON line per partition, then one per seed and kind with the
run's numbers: the mean cut share (`cut_frac_mean`, as a run compares it),
the largest cut share and the largest overload.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import cells, machine, run  # noqa: E402
from portbench.reference import partition as reference  # noqa: E402

KINDS = ("sound", "control_2eps", "fault_unrefined")


def solver_of(kind: str, session, kp, preset: str):
    """The facade that partitions for `kind`, and the epsilon it is given."""
    if kind == "sound":
        return session.solver, session.epsilon
    if kind == "control_2eps":
        solver, epsilon = kp.KaMinPar(preset, device=session.card.device), \
            2 * session.epsilon
    else:
        from kaminpar_tpu_torch.context import RefinementAlgorithm as algo

        ctx = kp.context_from_preset(preset)
        balancers = {algo.OVERLOAD_BALANCER, algo.UNDERLOAD_BALANCER}
        ctx.refinement.algorithms = [a for a in ctx.refinement.algorithms
                                     if a in balancers]
        solver, epsilon = kp.KaMinPar(ctx, device=session.card.device), \
            session.epsilon
    solver.set_output_level(0)
    solver.set_graph(session.solver.graph())
    return solver, epsilon


def reading(session, solver, epsilon: float, seed: int) -> dict:
    card = session.card
    card.reset_peak()
    t0 = time.perf_counter()
    part = solver.compute_partition(k=session.k, epsilon=epsilon, seed=seed)
    card.sync()
    wall = time.perf_counter() - t0
    gate = solver.last_gate
    counted = reference.recount(session.xadj, session.adjncy, part, session.k)
    judged = reference.judge(counted, session.k, session.epsilon,
                             len(session.xadj) - 1,
                             None if not gate else gate.get("cut_recomputed"))
    return {"wall_s": wall, "peak_bytes": card.peak(),
            "timings": dict(solver.last_timings), **judged}


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated graph seeds")
    ap.add_argument("--partitions", type=int, default=5,
                    help="partitions per seed and kind")
    ap.add_argument("--kinds", default=",".join(KINDS))
    args = ap.parse_args(argv)
    spec = cells.cell(args.workload)
    import torch

    import kaminpar_tpu_torch as kp

    torch.set_num_threads(run.HOST_THREADS)
    if device == "cuda":
        machine.require_cards(torch, int(spec.get("chips", 1)))
    card = run.Card(torch, device)
    preset = spec["traffic"]["preset"]
    for index, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        session = run.Session(spec, seed, card)
        if index == 0:
            session.partition(run.partition_seed(seed, 0))
        setup = time.perf_counter() - t0
        for kind in args.kinds.split(","):
            solver, epsilon = solver_of(kind, session, kp, preset)
            rows = []
            for i in range(1, args.partitions + 1):
                out = reading(session, solver, epsilon,
                              run.partition_seed(seed, i))
                rows.append(out)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "kind": kind, "partition": i,
                                  "setup_s": setup, **out}), flush=True)
            fracs = [r["cut_frac"] for r in rows]
            print(json.dumps({
                "workload": args.workload, "seed": seed, "kind": kind,
                "run": True, "cut_frac_mean": sum(fracs) / len(fracs),
                "cut_frac_max": max(fracs),
                "overload_max": max(r["overload"] for r in rows),
                "wall_s": [r["wall_s"] for r in rows]}), flush=True)
            del solver
        del session
    return 0


if __name__ == "__main__":
    sys.exit(main())
