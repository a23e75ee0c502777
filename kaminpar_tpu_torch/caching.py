"""Shape-bucket padding policy and graph identity (own copy of
kaminpar_tpu/caching.py's pad_size, pad_k, pad policy scopes, bucket_key,
BucketTracker and full_graph_digest).

"bucketed" (the default) pads to the next power of two over a
granularity floor; "tight" (the memory governor's rungs 1-3,
resilience/memory.py) pads to the next granularity multiple only.  The
mode is thread-local and scope-managed, so the default path is unchanged.

`bucket_key` compacts a request's (n, m, k) into the padded-shape triple
that decides whether a dynamic session's delta commits in place;
`BucketTracker` counts the sightings of those triples; and
`full_graph_digest` hashes a whole graph (or returns a session's stamped
chain digest), the base link of a session's delta chain.  The JAX
package's `BoundedCache` and `result_cache_key` serve its serving layer,
which this package does not have yet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Tuple


def _ceil2(x: int) -> int:
    """Smallest power of two >= x."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()

_pad_mode = threading.local()

PAD_POLICIES = ("bucketed", "tight")


def pad_policy() -> str:
    """The calling thread's active pad policy ("bucketed" by default)."""
    return getattr(_pad_mode, "mode", "bucketed")


@contextmanager
def pad_policy_scope(mode: str):
    """Run a block under a pad policy (the previous one is restored on
    exit)."""
    if mode not in PAD_POLICIES:
        raise ValueError(f"unknown pad policy {mode!r}")
    prev = pad_policy()
    _pad_mode.mode = mode
    try:
        yield
    finally:
        _pad_mode.mode = prev


def pad_size(x: int, granularity: int = 256) -> int:
    """Next power of two, but at least x rounded up to `granularity`; under
    the "tight" policy the next `granularity` multiple.  Both packages pad
    every level identically."""
    if x <= granularity:
        return granularity
    if pad_policy() == "tight":
        return ((x + granularity - 1) // granularity) * granularity
    return _ceil2(x)


def pad_k(k: int) -> int:
    """The block-count bucket: k rounded up to a power of two (>= 2)."""
    return max(2, 1 << (int(k) - 1).bit_length())


def bucket_key(n: int, m: int, k: int) -> Tuple[int, int, int]:
    """The padded-shape triple of a request: padded node slots, padded
    edge slots, padded block count."""
    return (pad_size(int(n) + 1), pad_size(max(int(m), 1)), pad_k(k))


class BucketTracker:
    """Reuse accounting over :func:`bucket_key` triples: the first
    sighting of a bucket is a miss, every later one a hit."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[int, int, int], int] = {}
        self.hits = 0
        self.misses = 0
        # per-window twins (begin_window)
        self.w_hits = 0
        self.w_misses = 0

    def observe(self, n: int, m: int, k: int) -> Tuple[int, int, int]:
        """Record one request's bucket; returns the key."""
        key = bucket_key(n, m, k)
        with self._lock:
            if key in self._seen:
                self._seen[key] += 1
                self.hits += 1
                self.w_hits += 1
            else:
                self._seen[key] = 1
                self.misses += 1
                self.w_misses += 1
        return key

    def begin_window(self) -> None:
        """Zero the per-window counters (sightings and lifetime totals
        are kept)."""
        with self._lock:
            self.w_hits = 0
            self.w_misses = 0

    def per_bucket(self) -> Dict[str, int]:
        """Lifetime sightings per bucket ("n/m/k" string keys)."""
        with self._lock:
            return {
                "/".join(str(x) for x in key): int(count)
                for key, count in self._seen.items()
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lookups = self.hits + self.misses
            w_lookups = self.w_hits + self.w_misses
            return {
                "buckets": len(self._seen),
                "hits": int(self.hits),
                "misses": int(self.misses),
                "hit_rate": (
                    round(self.hits / lookups, 4) if lookups else 0.0
                ),
                "window": {
                    "hits": int(self.w_hits),
                    "misses": int(self.w_misses),
                    "hit_rate": (
                        round(self.w_hits / w_lookups, 4)
                        if w_lookups else 0.0
                    ),
                },
            }


def full_graph_digest(graph) -> str:
    """Exact structural identity of a graph: a hash of the whole
    adjacency and both weight arrays, over the same bytes in the same
    order and dtypes as the JAX package (a compressed container is
    hashed as its encoded streams).  A graph that a dynamic session owns
    carries the session's chain digest (``_chain_digest``, "dyn:"
    prefixed, so it never equals the hex digest of a plain graph), which
    is returned instead: a mutate costs O(delta), never a fresh sweep."""
    import hashlib

    import numpy as np

    chain = getattr(graph, "_chain_digest", None)
    if chain is not None:
        return str(chain)
    h = hashlib.sha256()

    def _arr(a) -> None:
        if a is None:
            h.update(b"\x00none")
            return
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())

    h.update(f"n={int(graph.n)};m={int(graph.m)};".encode())
    if hasattr(graph, "data") and hasattr(graph, "offsets"):
        h.update(str(getattr(graph, "codec", "?")).encode())
        for name in ("xadj", "offsets", "data", "node_weights",
                     "edge_weights", "wdata", "woffsets"):
            _arr(getattr(graph, name, None))
    else:
        _arr(np.asarray(graph.xadj, dtype=np.int64))
        _arr(graph.adjncy)
        _arr(getattr(graph, "node_weights", None))
        _arr(getattr(graph, "edge_weights", None))
    return h.hexdigest()[:24]
