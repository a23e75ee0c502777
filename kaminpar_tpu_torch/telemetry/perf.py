"""Latency histograms (own copy of the `Histogram` class of
kaminpar_tpu/telemetry/perf.py).

:class:`Histogram` is a fixed log-spaced streaming histogram (p50/p95/p99
without storing samples); the serving layer keeps one per request phase
and per request class, and the live metrics registry renders one as a
Prometheus summary.

The rest of the JAX module (the roofline accounting over compiled
executables, the device-memory watermarks and the padding-waste
attribution) belongs to the observatory slice that follows and is not in
this package yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import bisect
import math
from typing import Optional, Tuple


class Histogram:
    """Fixed log-spaced streaming histogram over seconds.

    42 bucket edges from 100 µs up by sqrt(2) per bucket (~148 s span);
    a value exactly on an edge lands in the bucket *starting* at that
    edge, values below the first edge share bucket 0, values past the
    last edge share the final bucket.  Quantiles interpolate to the
    bucket's upper edge clamped to the observed maximum — conservative
    (never under-reports a latency SLO) and exact for boundary values.
    Single-writer by design (the serving loop is serial); snapshots are
    consistent under the GIL.
    """

    EDGES: Tuple[float, ...] = tuple(
        1e-4 * (2 ** (i / 2.0)) for i in range(42)
    )

    def __init__(self) -> None:
        self.counts = [0] * len(self.EDGES)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        v = max(float(seconds), 0.0)
        i = bisect.bisect_right(self.EDGES, v) - 1
        if i < 0:
            i = 0
        self.counts[i] += 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile in seconds (None when empty)."""
        if self.count == 0:
            return None
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                upper = (
                    self.EDGES[i + 1] if i + 1 < len(self.EDGES)
                    else self.max
                )
                return min(upper, self.max)
        return self.max

    def reset(self) -> None:
        self.counts = [0] * len(self.EDGES)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def snapshot(self) -> dict:
        """Report-ready summary (milliseconds; empty histograms report
        null quantiles rather than inventing a zero)."""
        def ms(v: Optional[float]) -> Optional[float]:
            return round(v * 1000.0, 3) if v is not None else None

        nonzero = [
            [ms(self.EDGES[i]), c]
            for i, c in enumerate(self.counts) if c
        ]
        return {
            "count": int(self.count),
            "mean_ms": ms(self.total / self.count) if self.count else None,
            "max_ms": ms(self.max) if self.count else None,
            "p50_ms": ms(self.quantile(0.50)),
            "p95_ms": ms(self.quantile(0.95)),
            "p99_ms": ms(self.quantile(0.99)),
            "buckets": nonzero,
        }
