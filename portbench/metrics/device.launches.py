"""Kernels launched on the card in one profiled partition, the hand-written
ones and torch's own, from torch.profiler (profiling.py)."""

LAYER = "device"
UNIT = "count"
MOVES = "partition_s"


def read(records):
    profile = records.get("profile")
    return None if profile is None else float(profile["launches"])
