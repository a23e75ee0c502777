"""Seconds of initial partitioning (initial/, native/ip.cpp):
`KaMinPar.last_timings["initial-partitioning"]`, a timer scope that waits
for the card at its exit; the mean over the window's partitions."""

LAYER = "initial partitioning"
UNIT = "s"
MOVES = "partition_s"
PHASE = "initial-partitioning"


def read(records):
    window = [r for r in records["window"] if PHASE in r["timings"]]
    if not window:
        return None
    return sum(r["timings"][PHASE] for r in window) / len(window)
