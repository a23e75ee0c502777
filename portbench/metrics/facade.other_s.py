"""Seconds of one `compute_partition` outside the scheme's top-level phases
(`KaMinPar.last_timings` keys without a "/"): the facade's isolated-node
handling, the memory governor and the output gate (kaminpar.py), and the
scheme's unscoped tail (the refinement after a final extension, the host
balance run, the projection).  The benchmark's host wall of the call
minus those phase walls; the mean over the window's partitions."""

LAYER = "facade"
UNIT = "s"
MOVES = "partition_s"


def read(records):
    window = [r for r in records["window"] if r["timings"]]
    if not window:
        return None
    rest = [r["wall_s"] - sum(v for k, v in r["timings"].items() if "/" not in k)
            for r in window]
    return sum(rest) / len(rest)
