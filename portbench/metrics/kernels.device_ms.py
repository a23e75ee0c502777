"""Milliseconds of device time of the program's hand-written CUDA kernels in
one profiled partition, matched by kernel name: K1 (gather_kernel), K2
(plan_kernel, ratings_kernel) and both K3s (best_from_slots_kernel,
fused_light_kernel, fused_heavy_kernel), from csrc/*.cu as the benchmark
was defined."""

import re

LAYER = "kernels"
UNIT = "ms"
MOVES = "partition_s"
KERNELS = re.compile(
    r"\b(gather_kernel|plan_kernel|ratings_kernel|best_from_slots_kernel"
    r"|fused_light_kernel|fused_heavy_kernel)\b")


def read(records):
    profile = records.get("profile")
    if profile is None:
        return None
    matched = [s for name, s in profile["kernel_s"].items()
               if KERNELS.search(name)]
    return sum(matched) * 1e3 if matched else None
