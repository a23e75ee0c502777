"""Share of one profiled partition's wall in which the card ran no kernel,
copy or memset: 100 * (1 - the union of their intervals / the wall), from
torch.profiler (profiling.py)."""

LAYER = "device"
UNIT = "%"
MOVES = "partition_s"


def read(records):
    profile = records.get("profile")
    if profile is None or profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
