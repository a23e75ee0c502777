"""Scoped memory profiler (own copy of kaminpar_tpu/utils/heap_profiler.py;
analog of kaminpar-common/heap_profiler.{h,cc}).

The reference interposes malloc (libc_memory_override.cc) and prints a
peak-memory tree per SCOPED_HEAP_PROFILER scope.  This process has two
memory domains to track:

  * host allocations: tracemalloc (stdlib), scoped snapshots;
  * device allocations: the CUDA caching allocator's counters,
    ``torch.cuda.max_memory_allocated`` (the peak) and
    ``torch.cuda.memory_allocated`` (live tensors), once this process
    has initialized CUDA; 0 on the CPU.

The tree's keys (scope names, counts) are the JAX package's; its byte
counts are each platform's own.  Profiling is off unless enabled (the
CLI's ``-H``); `enable()`/`disable()` toggle at run time.
"""

from __future__ import annotations

import tracemalloc
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

_enabled = False


@dataclass
class HeapNode:
    name: str
    peak_host_bytes: int = 0
    peak_device_bytes: int = 0
    live_device_bytes: int = 0
    count: int = 0
    children: Dict[str, "HeapNode"] = field(default_factory=dict)

    def child(self, name: str) -> "HeapNode":
        node = self.children.get(name)
        if node is None:
            node = HeapNode(name)
            self.children[name] = node
        return node


_root = HeapNode("root")
_stack = [_root]


def enable() -> None:
    global _enabled
    if not _enabled:
        tracemalloc.start()
        _enabled = True


def disable() -> None:
    global _enabled
    if _enabled:
        tracemalloc.stop()
        _enabled = False


def profiling_enabled() -> bool:
    return _enabled


def reset() -> None:
    global _root, _stack
    if len(_stack) > 1:
        return  # same open-scope guard as the timer
    _root = HeapNode("root")
    _stack = [_root]


def _cuda_in_use() -> bool:
    """Whether this process has initialized CUDA (the allocator's counters
    then describe the card; otherwise nothing lives there)."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _device_peak_bytes() -> int:
    """Process-lifetime device high-water mark of the caching allocator
    (0 on the CPU)."""
    if not _cuda_in_use():
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def _live_device_bytes() -> int:
    """Bytes held by live tensors on the card right now (0 on the CPU).

    Unlike the lifetime high-water mark this is a current figure, so
    per-phase peaks can be measured even after an earlier phase set a
    larger process-wide peak."""
    if not _cuda_in_use():
        return 0
    import torch

    return int(torch.cuda.memory_allocated())


def sample_device_memory() -> int:
    """Record the current live device figure into every OPEN scope.

    Call at phase boundaries (between device launches); returns the
    sampled byte count.  Scope entry/exit sample automatically, so this
    is only needed to catch peaks in the middle of a long scope."""
    if not _enabled:
        return 0
    live = _live_device_bytes()
    for node in _stack[1:]:
        node.live_device_bytes = max(node.live_device_bytes, live)
    return live


@contextmanager
def scoped_heap_profiler(name: str):
    """SCOPED_HEAP_PROFILER analog.

    Host: records how far above the scope-entry allocation level the
    traced peak rises while the scope is open (no reset_peak, so nested
    scopes don't clobber their parents' tracking).  Device: records the
    increase of the allocator's lifetime high-water mark during the scope —
    if the scope stays below an earlier process-wide peak this reads 0,
    an inherent limit of peak-only counters."""
    if not _enabled:
        yield
        return
    node = _stack[-1].child(name)
    _stack.append(node)
    cur0, peak0 = tracemalloc.get_traced_memory()
    dev_peak0 = _device_peak_bytes()
    node.live_device_bytes = max(node.live_device_bytes, _live_device_bytes())
    try:
        yield
    finally:
        _, peak1 = tracemalloc.get_traced_memory()
        if peak1 > peak0:  # a new high-water mark was set inside the scope
            node.peak_host_bytes = max(node.peak_host_bytes, peak1 - cur0)
        node.peak_device_bytes = max(
            node.peak_device_bytes, _device_peak_bytes() - dev_peak0
        )
        node.live_device_bytes = max(
            node.live_device_bytes, _live_device_bytes()
        )
        node.count += 1
        _stack.pop()


def record(name: str, nbytes: int) -> None:
    """RECORD("name") analog: annotate a data structure's footprint."""
    if not _enabled:
        return
    node = _stack[-1].child(name)
    node.peak_host_bytes = max(node.peak_host_bytes, int(nbytes))
    node.count += 1


def live_device_bytes() -> int:
    """Public probe of the current live device figure (the memory
    governor's live-bytes reading)."""
    return _live_device_bytes()


def tree_dict() -> dict:
    """The heap-profile tree as nested dicts (run-report `heap` section)."""

    def rec(node: HeapNode) -> dict:
        return {
            child.name: {
                "peak_host_bytes": child.peak_host_bytes,
                "peak_device_bytes": child.peak_device_bytes,
                "live_device_bytes": child.live_device_bytes,
                "count": child.count,
                "children": rec(child),
            }
            for child in node.children.values()
        }

    return rec(_root)


def _fmt(nbytes: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(nbytes) < 1024:
            return f"{nbytes:.0f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.1f} TiB"


def render() -> str:
    """PRINT_HEAP_PROFILE analog."""
    lines = []

    def rec(node: HeapNode, depth: int) -> None:
        if depth > 0:
            extra = (
                f", device {_fmt(node.peak_device_bytes)}"
                if node.peak_device_bytes
                else ""
            )
            if node.live_device_bytes:
                extra += f", live HBM {_fmt(node.live_device_bytes)}"
            lines.append(
                f"{'  ' * depth}{node.name}: peak {_fmt(node.peak_host_bytes)}"
                f"{extra}"
            )
        for child in node.children.values():
            rec(child, depth + 1)

    rec(_root, 0)
    return "\n".join(lines) if lines else "(heap profiler: no scopes recorded)"
