"""Seconds of uncoarsening (partitioning/refiner.py, ops/jet.py,
ops/balancer.py, extend-partition): `KaMinPar.last_timings["uncoarsening"]`
plus the top-level "extend-partition" phase, the extensions to the input's
k that the deep scheme makes after the uncoarsening loop (large k); each a
timer scope that waits for the card at its exit.  The mean over the
window's partitions."""

LAYER = "uncoarsening"
UNIT = "s"
MOVES = "partition_s"
PHASES = ("uncoarsening", "extend-partition")


def read(records):
    window = [r for r in records["window"] if PHASES[0] in r["timings"]]
    if not window:
        return None
    return sum(sum(r["timings"].get(p, 0.0) for p in PHASES)
               for r in window) / len(window)
