"""Seconds of coarsening (partitioning/coarsener.py, ops/lp.py,
ops/contraction.py): `KaMinPar.last_timings["coarsening"]`, a timer scope
that waits for the card at its exit; the mean over the window's
partitions."""

LAYER = "coarsening"
UNIT = "s"
MOVES = "partition_s"
PHASE = "coarsening"


def read(records):
    window = [r for r in records["window"] if PHASE in r["timings"]]
    if not window:
        return None
    return sum(r["timings"][PHASE] for r in window) / len(window)
