"""Live metrics registry and Prometheus text-format exporter (own copy
of kaminpar_tpu/telemetry/metrics.py).

A thread-safe registry of counters, gauges, windowed rates and latency
histograms (:class:`.perf.Histogram`) that the serving, supervision and
dist layers feed, exported on a cadence as Prometheus text format (0.0.4)
to a file an operator, or node_exporter's textfile collector, can scrape.
Metric names, help texts and label sets are the JAX package's.

Dormant by default: producers call through :func:`enabled`-guarded
helpers that return at once unless a metrics file was configured by
``--metrics-file`` (both CLIs), ``ServiceConfig.metrics_file`` or the
``KAMINPAR_TPU_METRICS_FILE`` environment variable, so a producer costs
one attribute read.  Every producer is host-side bookkeeping; no kernel
or tensor operation changes when the exporter is on.

One difference from the JAX package: its ``kmp_comm_*`` counters count
collectives when a program is traced, once per compiled program, while
this package runs eagerly and counts every call
(parallel/mesh.py ``account_collective``), as its ``--comm-table`` does;
their help texts say so.

Export is atomic (a temporary file and ``os.replace`` in the target
directory), so a scrape mid-batch never sees a torn file.  A background
thread (every 2 s, ``KAMINPAR_TPU_METRICS_CADENCE_S``) rewrites the file
while work is in flight; :func:`write_now` forces a write at batch
boundaries so a short CLI run always leaves a final scrape behind.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .perf import Histogram

ENV_VAR = "KAMINPAR_TPU_METRICS_FILE"
ENV_CADENCE = "KAMINPAR_TPU_METRICS_CADENCE_S"
DEFAULT_CADENCE_S = 2.0

#: Sliding window the requests_per_second figure is computed over.
DEFAULT_WINDOW_S = 30.0

#: Every metric this module exports carries the kmp_ namespace prefix.
PREFIX = "kmp_"

_lock = threading.RLock()
_path: Optional[str] = None
_cadence_s: float = DEFAULT_CADENCE_S
_thread: Optional[threading.Thread] = None
_stop = threading.Event()
_metrics: "Dict[str, _Metric]" = {}
_atexit_armed = False


# ---------------------------------------------------------------------------
# metric kinds
# ---------------------------------------------------------------------------


class _Metric:
    """Base: a named family with fixed label names and per-labelset
    float samples.  All mutation happens under the module lock."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        return tuple(str(labels.get(k, "")) for k in self.labelnames)

    def samples(self) -> List[Tuple[Tuple[str, ...], float]]:
        with _lock:
            return sorted(self.values.items())

    def clear(self) -> None:
        with _lock:
            self.values.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with _lock:
            self.values[key] = self.values.get(key, 0.0) + float(value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with _lock:
            self.values[self._key(labels)] = float(value)


class WindowRate(_Metric):
    """Events-per-second over a sliding window (the live
    ``requests_per_second`` figure).

    ``rate()`` counts the
    marks inside the trailing ``window_s`` seconds and divides by the
    window actually *covered* — ``min(window_s, now - first_mark)`` —
    floored at 1 s so a burst in the first instant reads as events/s,
    not events/ε.  The clock is injectable for deterministic tests.
    """

    kind = "gauge"

    def __init__(self, name: str, help_text: str,
                 window_s: float = DEFAULT_WINDOW_S,
                 clock: Callable[[], float] = time.monotonic) -> None:
        super().__init__(name, help_text, ())
        self.window_s = float(window_s)
        self.clock = clock
        self._stamps: deque = deque()
        self._t_first: Optional[float] = None

    def mark(self, n: int = 1) -> None:
        now = self.clock()
        with _lock:
            if self._t_first is None:
                self._t_first = now
            for _ in range(int(n)):
                self._stamps.append(now)
            self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._stamps and self._stamps[0] < horizon:
            self._stamps.popleft()

    def rate(self) -> float:
        now = self.clock()
        with _lock:
            self._prune(now)
            if not self._stamps or self._t_first is None:
                return 0.0
            covered = max(1.0, min(self.window_s, now - self._t_first))
            return len(self._stamps) / covered

    def samples(self) -> List[Tuple[Tuple[str, ...], float]]:
        return [((), self.rate())]

    def clear(self) -> None:
        with _lock:
            self._stamps.clear()
            self._t_first = None


class HistogramMetric(_Metric):
    """A perf.Histogram rendered as a Prometheus summary (quantile
    labels + _sum/_count) — the registry twin of the serving layer's
    per-phase latency histograms."""

    kind = "summary"

    def __init__(self, name: str, help_text: str) -> None:
        super().__init__(name, help_text, ())
        self.hist = Histogram()

    def observe(self, seconds: float) -> None:
        with _lock:
            self.hist.record(seconds)

    def clear(self) -> None:
        with _lock:
            self.hist.reset()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _get_or_make(cls, name: str, help_text: str, labelnames=(),
                 **kwargs: Any):
    with _lock:
        m = _metrics.get(name)
        if m is None:
            if cls is HistogramMetric or cls is WindowRate:
                m = cls(name, help_text, **kwargs)
            else:
                m = cls(name, help_text, labelnames)
            _metrics[name] = m
        return m


def counter(name: str, help_text: str = "", labelnames=()) -> Counter:
    return _get_or_make(Counter, name, help_text, labelnames)


def gauge(name: str, help_text: str = "", labelnames=()) -> Gauge:
    return _get_or_make(Gauge, name, help_text, labelnames)


def window_rate(name: str, help_text: str = "",
                window_s: float = DEFAULT_WINDOW_S,
                clock: Callable[[], float] = time.monotonic
                ) -> WindowRate:
    return _get_or_make(WindowRate, name, help_text,
                        window_s=window_s, clock=clock)


def histogram(name: str, help_text: str = "") -> HistogramMetric:
    return _get_or_make(HistogramMetric, name, help_text)


# ---------------------------------------------------------------------------
# producer-facing helpers (no-ops while dormant)
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """True iff a metrics file has been configured — the single gate
    every producer checks before touching the registry."""
    return _path is not None


def inc(name: str, help_text: str = "", value: float = 1.0,
        **labels: Any) -> None:
    if not enabled():
        return
    counter(name, help_text, tuple(sorted(labels))).inc(value, **labels)


def set_gauge(name: str, value: float, help_text: str = "",
              **labels: Any) -> None:
    if not enabled():
        return
    gauge(name, help_text, tuple(sorted(labels))).set(value, **labels)


def observe(name: str, seconds: float, help_text: str = "") -> None:
    if not enabled():
        return
    histogram(name, help_text).observe(seconds)


def mark(name: str, help_text: str = "", n: int = 1) -> None:
    if not enabled():
        return
    window_rate(name, help_text).mark(n)


def rate(name: str) -> float:
    """Current value of a windowed rate (0.0 when absent/dormant)."""
    with _lock:
        m = _metrics.get(name)
    return m.rate() if isinstance(m, WindowRate) else 0.0


def gauge_value(name: str, **labels: Any) -> Optional[float]:
    """Current value of a gauge/counter labelset (None when absent)."""
    with _lock:
        m = _metrics.get(name)
        if m is None or isinstance(m, (WindowRate, HistogramMetric)):
            return None
        return m.values.get(m._key(labels))


# ---------------------------------------------------------------------------
# Prometheus text rendering
# ---------------------------------------------------------------------------


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _render_labels(labelnames: Tuple[str, ...],
                   labelvalues: Tuple[str, ...],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    parts = [
        f'{k}="{_escape_label(v)}"'
        for k, v in zip(labelnames, labelvalues)
    ]
    if extra is not None:
        parts.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def render() -> str:
    """The registry as Prometheus text format (version 0.0.4)."""
    lines: List[str] = []
    with _lock:
        families = sorted(_metrics.values(), key=lambda m: m.name)
    for m in families:
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, HistogramMetric):
            with _lock:
                h = m.hist
                count, total = h.count, h.total
                quantiles = [
                    (q, h.quantile(q)) for q in (0.5, 0.95, 0.99)
                ]
            for q, v in quantiles:
                if v is None:
                    continue
                lines.append(
                    f"{m.name}"
                    f'{{quantile="{q}"}} {_fmt(v)}'
                )
            lines.append(f"{m.name}_sum {_fmt(total)}")
            lines.append(f"{m.name}_count {_fmt(float(count))}")
            continue
        for labelvalues, value in m.samples():
            labels = _render_labels(m.labelnames, labelvalues)
            lines.append(f"{m.name}{labels} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# exporter: configure / cadence thread / atomic writes
# ---------------------------------------------------------------------------


def configure(path: Optional[str] = None,
              cadence_s: Optional[float] = None) -> bool:
    """Arm the exporter.  ``path`` wins over ``KAMINPAR_TPU_METRICS_FILE``;
    with neither set this is a no-op and the registry stays dormant.
    Returns True iff the exporter is (now) armed.  Idempotent — a second
    call with a path just re-points the file."""
    global _path, _cadence_s, _atexit_armed
    resolved = path or os.environ.get(ENV_VAR, "")
    if not resolved:
        return enabled()
    with _lock:
        _path = resolved
        raw = os.environ.get(ENV_CADENCE, "")
        if cadence_s is not None:
            _cadence_s = float(cadence_s)
        elif raw:
            try:
                _cadence_s = float(raw)
            except ValueError:
                pass
        if not _atexit_armed:
            # every CLI exit path leaves a final scrape behind without
            # per-return-point wiring (a no-op once reset() disarmed)
            import atexit

            atexit.register(shutdown)
            _atexit_armed = True
    _start_thread()
    return True


def _start_thread() -> None:
    global _thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _stop.clear()
        _thread = threading.Thread(
            target=_cadence_loop, name="kmp-metrics-exporter", daemon=True
        )
        _thread.start()


def _cadence_loop() -> None:
    while not _stop.wait(_cadence_s):
        try:
            write_now()
        except Exception:
            pass  # the exporter must never take the service down


def write_now() -> Optional[str]:
    """Render and atomically publish the scrape file (tmp +
    ``os.replace`` in the target directory — a reader never observes a
    torn write).  Returns the path written, or None while dormant."""
    path = _path
    if path is None:
        return None
    text = render()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def shutdown(final_write: bool = True) -> None:
    """Stop the cadence thread (tests; CLI exit).  Leaves the registry
    and path armed so a final :func:`write_now` still works."""
    global _thread
    _stop.set()
    t = _thread
    if t is not None and t.is_alive():
        t.join(timeout=5.0)
    _thread = None
    if final_write and enabled():
        try:
            write_now()
        except Exception:
            pass


def reset() -> None:
    """Disarm and clear everything (test isolation)."""
    global _path, _cadence_s
    shutdown(final_write=False)
    with _lock:
        _path = None
        _cadence_s = DEFAULT_CADENCE_S
        _metrics.clear()


def snapshot() -> Dict[str, Any]:
    """Registry contents as plain data (tests, the top comm panel)."""
    out: Dict[str, Any] = {}
    with _lock:
        metrics = dict(_metrics)
    for name, m in sorted(metrics.items()):
        if isinstance(m, HistogramMetric):
            out[name] = m.hist.snapshot()
        elif isinstance(m, WindowRate):
            out[name] = round(m.rate(), 4)
        else:
            out[name] = {
                ",".join(k) if k else "": v
                for k, v in m.samples()
            }
    return out
