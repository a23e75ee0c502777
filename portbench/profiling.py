"""One partition under torch.profiler, reduced to what the per-layer metrics
and the result's `breakdown` read.

The profiler records the card's kernels, copies and memsets (CUPTI) and the
host's torch ops.  While it runs, each scope of the program's timer is also
opened as a profiler range, so that the host's own work between torch ops
is named by the phase it belongs to.  CUPTI at times hands back a session
with no device records; the partition is then profiled again, at most
`ATTEMPTS` times in all.  The raw events are read from the profiler's
kineto result, without building torch's event tree, which takes minutes on
a partition of a large graph.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import numpy as np

ATTEMPTS = 3
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160  # kernel names of templates run to kilobytes


@contextmanager
def timer_scopes_as_ranges(torch, names: set):
    """Open each scope of the program's timer as a profiler range while the
    block runs, and collect the scopes' names into `names`; a program
    without that timer is left as it is."""
    timer_mod = sys.modules.get("kaminpar_tpu_torch.utils.timer")
    cls = getattr(timer_mod, "Timer", None)
    original = getattr(cls, "scope", None)
    if original is None:
        yield
        return

    @contextmanager
    def scope(self, name, *args, **kwargs):
        names.add(str(name))
        with torch.profiler.record_function(str(name)):
            with original(self, name, *args, **kwargs) as timing:
                yield timing

    cls.scope = scope
    try:
        yield
    finally:
        cls.scope = original


def kind_of(ev, ranges: set) -> str:
    """The kineto activity of an event: `activity_type()` where torch has
    it; else from the device, the name and the ranges this module opened
    (their device-side shadows are not work)."""
    activity = getattr(ev, "activity_type", None)
    if activity is not None:
        return str(activity())
    name = ev.name()
    if str(ev.device_type()).endswith("CUDA"):
        if name in ranges:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if name in ranges else "cpu_op"


def profile_call(solve, torch, deadline: float = float("inf")):
    """(solve's result, summary or None): `solve()` under the profiler,
    again while CUPTI recorded nothing and another attempt as long as the
    last would end before `deadline` (a `time.perf_counter()` value)."""
    from torch.profiler import ProfilerActivity, profile

    result = None
    for attempt in range(ATTEMPTS):
        started = time.perf_counter()
        ranges = set()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with timer_scopes_as_ranges(torch, ranges):
                t0 = time.perf_counter()
                result = solve()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        summary = reduce_events(prof.profiler.kineto_results.events(), wall,
                                ranges)
        if summary is not None:
            return result, summary
        print(f"portbench: the profiler recorded no device time "
              f"(attempt {attempt + 1} of {ATTEMPTS})", file=sys.stderr)
        now = time.perf_counter()
        if now + (now - started) > deadline:
            break
    return result, None


def union(starts: np.ndarray, ends: np.ndarray):
    """(lo, hi) of the disjoint intervals that cover the given ones."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    return s[first], np.maximum.reduceat(e, first)


def name_gaps(mids: np.ndarray, ops: list) -> list:
    """The innermost host op or range open at each of the sorted `mids`
    (`ops`: (start, end, name) of one thread, nested)."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    names = []
    stack = []
    j = 0
    for mid in mids:
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no torch op or scope open)")
    return names


def reduce_events(events, wall_s: float, ranges: set = frozenset()):
    """Busy seconds (the union of the device's kernels, copies and
    memsets), kernel launches, device seconds by name, and idle seconds by
    what the host had open, from kineto events; None without device
    events."""
    dev_s, dev_e, dev_name, dev_kind = [], [], [], []
    host = {}
    for ev in events:
        kind = kind_of(ev, ranges)
        if kind in DEVICE_KINDS:
            dev_s.append(ev.start_ns())
            dev_e.append(ev.end_ns())
            dev_name.append(ev.name())
            dev_kind.append(kind)
        elif kind in HOST_KINDS:
            host.setdefault(ev.start_thread_id(), []).append(
                (ev.start_ns(), ev.end_ns(), ev.name()))
    if not dev_s:
        return None
    starts = np.asarray(dev_s, dtype=np.int64)
    ends = np.asarray(dev_e, dtype=np.int64)
    lo, hi = union(starts, ends)
    busy_s = float((hi - lo).sum()) / 1e9

    by_name = {}
    for name, dur in zip(dev_name, (ends - starts).tolist()):
        by_name[name] = by_name.get(name, 0) + dur
    kernel_s = {}
    for name, kind in zip(dev_name, dev_kind):
        if kind == "kernel":
            kernel_s[name] = by_name[name] / 1e9

    ops = max(host.values(), key=len) if host else []
    gap_lo = hi[:-1]
    gap_hi = lo[1:]
    if ops:
        first = min(o[0] for o in ops)
        last = max(o[1] for o in ops)
        gap_lo = np.concatenate([[first], gap_lo, [hi[-1]]])
        gap_hi = np.concatenate([[lo[0]], gap_hi, [last]])
    length = gap_hi - gap_lo
    keep = length > 0
    gap_lo, length = gap_lo[keep], length[keep]
    idle = {}
    mids = gap_lo + length // 2
    for name, ns in zip(name_gaps(mids, ops), length.tolist()):
        idle[name] = idle.get(name, 0) + ns
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": float(wall_s),
        "busy_s": busy_s,
        "launches": int(sum(1 for k in dev_kind if k == "kernel")),
        "kernel_s": kernel_s,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in top_dev],
        "idle_gaps": [[n[:NAME_CHARS], ns / 1e9] for n, ns in top_idle],
    }
