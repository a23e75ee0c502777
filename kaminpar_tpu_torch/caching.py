"""Shape-bucket padding policy, graph identity and the serving caches (own
copy of kaminpar_tpu/caching.py's pad_size, pad_k, pad policy scopes,
bucket_key, BoundedCache, BucketTracker, full_graph_digest and
result_cache_key).

"bucketed" (the default) pads to the next power of two over a
granularity floor; "tight" (the memory governor's rungs 1-3,
resilience/memory.py) pads to the next granularity multiple only.  The
mode is thread-local and scope-managed, so the default path is unchanged.

`bucket_key` compacts a request's (n, m, k) into the padded-shape triple
that decides whether a dynamic session's delta commits in place;
`BucketTracker` counts the sightings of those triples; and
`full_graph_digest` hashes a whole graph (or returns a session's stamped
chain digest), the base link of a session's delta chain.
`BoundedCache` is the serving layer's LRU result cache under an entry
cap and a byte budget, keyed by `result_cache_key`; the memory governor
sheds it under device-memory pressure (resilience/memory.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, Hashable, Optional, Tuple


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


class BoundedCache:
    """A thread-safe LRU cache with an entry cap and a byte budget.

    ``put(key, value, nbytes)`` evicts least-recently-used entries until
    both bounds hold; a single value larger than the byte budget is
    refused (``stats()['oversize']`` counts these) rather than evicting
    the whole cache for one entry.  ``get`` returns None on miss —
    callers that need to distinguish a cached None should wrap values.
    """

    def __init__(self, max_entries: int = 128,
                 max_bytes: int = 256 << 20) -> None:
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Tuple[Any, int]]" = (
            OrderedDict()
        )
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversize = 0
        # eviction-cause split: `capacity` evictions keep the configured
        # bounds (put overflow), `pressure` evictions were demanded by
        # the memory governor (evict_to) — the serving report separates
        # the two so a shrinking cache under HBM pressure is tellable
        # from ordinary LRU turnover
        self.evictions_capacity = 0
        self.evictions_pressure = 0
        # per-window twins (begin_window): a long-lived serving process
        # reports fresh per-window rates instead of lifetime averages
        # that asymptotically freeze under sustained traffic
        self.w_hits = 0
        self.w_misses = 0
        self.w_evictions = 0
        self.w_oversize = 0
        self.w_evictions_capacity = 0
        self.w_evictions_pressure = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                self.w_misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self.w_hits += 1
            return ent[0]

    def put(self, key: Hashable, value: Any, nbytes: int = 0) -> bool:
        """Insert (replacing any existing entry); returns False when the
        value alone exceeds the byte budget and was refused."""
        nbytes = int(nbytes)
        with self._lock:
            if nbytes > self.max_bytes:
                self.oversize += 1
                self.w_oversize += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while (
                len(self._entries) > self.max_entries
                or self._bytes > self.max_bytes
            ):
                _, (_, dropped) = self._entries.popitem(last=False)
                self._bytes -= dropped
                self.evictions += 1
                self.w_evictions += 1
                self.evictions_capacity += 1
                self.w_evictions_capacity += 1
            return True

    def evict(self, key: Hashable) -> bool:
        """Drop one entry (the serving-cache fault's forced-evict mode);
        returns True when something was removed."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return False
            self._bytes -= ent[1]
            self.evictions += 1
            self.evictions_capacity += 1
            return True

    def evict_to(self, target_bytes: int, cause: str = "pressure") -> int:
        """Shed least-recently-used entries until the cache holds at most
        ``target_bytes`` (0 sheds every byte-carrying entry; zero-byte
        entries hold no device memory and are left alone).  Returns the
        bytes freed.  The
        memory governor's pressure hook and the OOM recovery ladder call
        this with cause="pressure" — those evictions are counted apart
        from ordinary capacity turnover (`stats()['evictions_pressure']`)
        so an operator can see what HBM pressure cost the cache."""
        target_bytes = max(0, int(target_bytes))
        freed = 0
        with self._lock:
            carrying = [k for k, (_, nb) in self._entries.items() if nb > 0]
            for key in carrying:
                if self._bytes <= target_bytes:
                    break
                _, dropped = self._entries.pop(key)
                self._bytes -= dropped
                freed += dropped
                self.evictions += 1
                self.w_evictions += 1
                if cause == "pressure":
                    self.evictions_pressure += 1
                    self.w_evictions_pressure += 1
                else:
                    self.evictions_capacity += 1
                    self.w_evictions_capacity += 1
        return freed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def begin_window(self) -> None:
        """Zero the per-window counters (lifetime totals are kept) —
        called by the serving layer's `reset_records()` so each exported
        report window carries its own hit rate."""
        with self._lock:
            self.w_hits = 0
            self.w_misses = 0
            self.w_evictions = 0
            self.w_oversize = 0
            self.w_evictions_capacity = 0
            self.w_evictions_pressure = 0

    def stats(self) -> Dict[str, Any]:
        """Counter snapshot (the run report's cache subsections):
        lifetime totals plus the current window's counters."""
        with self._lock:
            lookups = self.hits + self.misses
            w_lookups = self.w_hits + self.w_misses
            return {
                "entries": len(self._entries),
                "bytes": int(self._bytes),
                "max_entries": self.max_entries,
                "max_bytes": int(self.max_bytes),
                "hits": int(self.hits),
                "misses": int(self.misses),
                "evictions": int(self.evictions),
                "evictions_capacity": int(self.evictions_capacity),
                "evictions_pressure": int(self.evictions_pressure),
                "oversize": int(self.oversize),
                "hit_rate": (
                    round(self.hits / lookups, 4) if lookups else 0.0
                ),
                "window": {
                    "hits": int(self.w_hits),
                    "misses": int(self.w_misses),
                    "evictions": int(self.w_evictions),
                    "evictions_capacity": int(self.w_evictions_capacity),
                    "evictions_pressure": int(self.w_evictions_pressure),
                    "oversize": int(self.w_oversize),
                    "hit_rate": (
                        round(self.w_hits / w_lookups, 4)
                        if w_lookups else 0.0
                    ),
                },
            }


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


def result_cache_key(graph, ctx) -> Tuple[str, str]:
    """The (graph identity, ctx fingerprint) a cached result is valid
    for.  The graph identity is the checkpoints' sampling
    ``graph_fingerprint`` (so the cache and resume agree on the prefix)
    strengthened with :func:`full_graph_digest` — the sampling
    fingerprint alone ignores edge weights and interior structure, which
    a replaying cache cannot afford.  The ctx fingerprint covers seed,
    k, epsilon, preset and every algorithm knob, and excludes the
    resilience/debug subtrees — a per-request deadline does not fork the
    cache key."""
    from .resilience.checkpoint import ctx_fingerprint, graph_fingerprint

    return (
        graph_fingerprint(graph) + ":" + full_graph_digest(graph),
        ctx_fingerprint(ctx),
    )
