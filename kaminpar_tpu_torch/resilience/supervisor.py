"""Hang and crash containment: watchdog, heartbeats, supervised workers
(own copy of kaminpar_tpu/resilience/supervisor.py).

The cooperative deadline budget (resilience/deadline.py) is checked
*between* kernel launches: a launch that never returns, or a crash in a
native library, never gives control back to the barrier that would have
noticed.  This module contains that failure class, in three pieces:

  * **hard wall-clock watchdog**: one daemon thread holding a schedule of
    *armed stages* (:func:`stage_guard`).  A stage past its hard ceiling
    becomes a structured :class:`~.errors.StageHang` carrying the stuck
    timer-scope path: the hang lands in telemetry and the run report, and
    a ``StageHang`` is delivered into the armed thread
    (``PyThreadState_SetAsyncExc``).  It lands at the next *bytecode*
    boundary.  This package's kernels are ctypes calls and
    ``torch.cuda.synchronize()`` releases the GIL, so a thread blocked
    inside a launch or a synchronize is detected and reported (and the
    heartbeat stalls) but is only interrupted once the call returns.
    Process isolation is what contains such a hang: the supervisor
    SIGKILLs the worker;

  * **supervised worker execution**: :class:`WorkerPool` runs compute in
    a warm, reused worker process started with the ``spawn`` method (a
    forked child of a process that has touched CUDA cannot use the card).
    The worker imports torch, creates its own CUDA context, loads the
    kernels the parent built into ``_build/``, and computes on the
    service's device, never falling back to the CPU: a worker that cannot
    reach the card fails the request with a marshalled error.  The graph
    travels as a checksummed npz (io/snapshot.py), the partition back the
    same way.  A worker past its ceiling is SIGKILLed and surfaces as a
    ``StageHang`` (site ``worker-hang``); a worker that dies (a segfault,
    an OOM kill, an injected SIGKILL) as :class:`~.errors.WorkerCrash`;
    the parent keeps draining its queue either way.  Workers are recycled
    after N requests or past an RSS watermark, and classified in-worker
    failures (a ladder-retryable DeviceOOM, a refiner refusal) are
    marshalled back and re-raised as their own types, so the serving
    breaker sees the verdicts it would have seen in-process;

  * **liveness heartbeats**: ``--heartbeat-file`` (or
    ``KAMINPAR_TPU_HEARTBEAT_FILE``) names a file whose mtime advances at
    every checkpoint barrier and from the watchdog tick *while no armed
    stage is past its ceiling*, so an external supervisor (a k8s liveness
    probe, systemd ``WatchdogSec``) tells slow-but-alive (the mtime
    advances) from hung (the mtime is frozen) without parsing output.

Hard-ceiling resolution (:func:`hard_ceiling`): ``KAMINPAR_TPU_HARD_DEADLINE_S``
wins; otherwise a run with a cooperative budget gets
``max(factor * budget, budget + grace)``, the ``budget + grace`` floor
keeping a tight anytime budget from arming a ceiling shorter than its own
wind-down.  No budget and no variable means no ceiling.

Everything here is host-side, and a disabled configuration costs one
attribute read per hook.
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

ENV_HARD_DEADLINE_S = "KAMINPAR_TPU_HARD_DEADLINE_S"
ENV_HEARTBEAT_FILE = "KAMINPAR_TPU_HEARTBEAT_FILE"

#: Default multiple of the cooperative budget that arms the hard
#: ceiling (ctx.resilience.hard_deadline_factor / ServiceConfig).
DEFAULT_HARD_FACTOR = 10.0

#: Declared wind-down allowance folded into the derived ceiling (the
#: deadline module's advisory grace — the mandatory tail must fit
#: under the hard ceiling or a slow-but-legitimate wind-down would be
#: classified as a hang).
from .runstate import DEFAULT_GRACE_S

#: How long the supervisor waits past a worker's hard ceiling before
#: SIGKILL — the child's own watchdog gets this window to convert a
#: python-level hang into a graceful marshalled StageHang first.
def _kill_grace(ceiling_s: float) -> float:
    return max(1.0, 0.25 * ceiling_s)


#: Worker spawn handshake budget: interpreter start + package import.
WORKER_SPAWN_TIMEOUT_S = 120.0

#: Watchdog tick while stages are armed (also the heartbeat cadence
#: while idle-but-configured).
_TICK_S = 0.2
_IDLE_TICK_S = 1.0


def env_ceiling() -> Optional[float]:
    """The explicit env hard ceiling (None = unset/disabled)."""
    raw = os.environ.get(ENV_HARD_DEADLINE_S, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def hard_ceiling(
    budget_s: Optional[float],
    grace_s: Optional[float] = None,
    factor: Optional[float] = None,
) -> Optional[float]:
    """Resolve the hard wall-clock ceiling for a run (None = no
    ceiling).  Env override first; else derived from the cooperative
    budget as ``max(factor * budget, budget + grace)``."""
    env = env_ceiling()
    if env is not None:
        return env
    budget = float(budget_s or 0.0)
    f = DEFAULT_HARD_FACTOR if factor is None else float(factor)
    if budget <= 0 or f <= 0:
        return None
    grace = DEFAULT_GRACE_S if grace_s is None else float(grace_s)
    return max(f * budget, budget + grace)


# ---------------------------------------------------------------------------
# heartbeat
# ---------------------------------------------------------------------------

_hb_lock = threading.Lock()
_hb_path: Optional[str] = None
_hb_count = 0


def set_heartbeat(path: Optional[str]) -> None:
    """Configure (or clear, with None/"") the liveness heartbeat file.
    Called by the CLIs (``--heartbeat-file``) and the serving config;
    the env var is folded in lazily by :func:`heartbeat_path`."""
    global _hb_path
    with _hb_lock:
        _hb_path = path or None
    if _hb_path:
        wd = _watchdog()
        wd.ensure_running()
        with wd._cond:
            wd._cond.notify()  # wake a parked tick loop
        heartbeat_touch()


def heartbeat_path() -> Optional[str]:
    with _hb_lock:
        if _hb_path:
            return _hb_path
    env = os.environ.get(ENV_HEARTBEAT_FILE, "").strip()
    if env:
        set_heartbeat(env)
        return env
    return None


def heartbeat_touch() -> None:
    """Advance the heartbeat file's mtime (one attribute read when no
    file is configured).  Strictly-increasing nanosecond stamps, so
    external ``stat`` pollers never see a frozen mtime from two touches
    inside one clock granule."""
    global _hb_count
    path = _hb_path or heartbeat_path()
    if not path:
        return
    try:
        if not os.path.exists(path):
            with open(path, "a"):
                pass
        now = time.time_ns()
        os.utime(path, ns=(now, now))
    except OSError:
        return
    with _hb_lock:
        _hb_count += 1


def heartbeat_state() -> Dict[str, Any]:
    with _hb_lock:
        return {"file": _hb_path, "count": int(_hb_count)}


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


class _Armed:
    __slots__ = ("token", "stage", "deadline", "ceiling_s", "thread_id",
                 "interrupt", "notify", "expired")

    def __init__(self, token, stage, deadline, ceiling_s, thread_id,
                 interrupt, notify):
        self.token = token
        self.stage = stage
        self.deadline = deadline
        self.ceiling_s = ceiling_s
        self.thread_id = thread_id
        self.interrupt = interrupt
        self.notify = notify
        self.expired = False


def _scope_path() -> str:
    """Best-effort dotted path of the currently open timer scopes (the
    'where is it stuck' attachment on a hang record).  Read racily from
    the watchdog thread — the armed thread is by definition not making
    progress when this matters."""
    try:
        from ..utils import timer

        return ".".join(n.name for n in timer.GLOBAL_TIMER._stack[1:])
    except Exception:
        return ""


def _async_raise(thread_id: int, exc_class) -> bool:
    """Deliver ``exc_class`` into the thread (next bytecode boundary)."""
    import ctypes

    try:
        res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), ctypes.py_object(exc_class)
        )
        if res > 1:  # undocumented multi-thread hit: undo, stay safe
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread_id), None
            )
            return False
        return res == 1
    except Exception:
        return False


class Watchdog:
    """One daemon thread, a schedule of armed stages, a hang log."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._armed: Dict[int, _Armed] = {}
        self._next_token = 1
        self._thread: Optional[threading.Thread] = None
        self.armed_total = 0
        self.fired = 0
        self.hangs: List[dict] = []

    # -- arming --------------------------------------------------------

    def arm(self, stage: str, ceiling_s: float, *,
            thread_id: Optional[int] = None, interrupt: bool = True,
            notify=None) -> int:
        with self._cond:
            token = self._next_token
            self._next_token += 1
            self._armed[token] = _Armed(
                token, stage, time.monotonic() + float(ceiling_s),
                float(ceiling_s),
                thread_id if thread_id is not None
                else threading.get_ident(),
                interrupt, notify,
            )
            self.armed_total += 1
            self._cond.notify()
        self.ensure_running()
        return token

    def disarm(self, token: int) -> None:
        with self._cond:
            self._armed.pop(token, None)
            self._cond.notify()

    def ensure_running(self) -> None:
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, name="kmp-watchdog", daemon=True
            )
            self._thread.start()

    # -- the tick loop -------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                armed = list(self._armed.values())
                if not armed and not (_hb_path or heartbeat_path()):
                    self._cond.wait()
                    continue
            now = time.monotonic()
            hung = False
            for a in armed:
                if a.expired:
                    hung = True
                elif now >= a.deadline:
                    a.expired = True
                    hung = True
                    self._expire(a)
            if not hung:
                # slow-but-alive: the heartbeat keeps advancing; a stage
                # past its ceiling freezes it, which is the external
                # supervisor's signal to act
                heartbeat_touch()
            with self._cond:
                self._cond.wait(_TICK_S if self._armed else _IDLE_TICK_S)

    def _expire(self, a: _Armed) -> None:
        # recheck membership under the lock: the stage may have
        # finished (and disarmed) between the tick loop's snapshot and
        # now — async-raising into a thread whose stage completed would
        # poison unrelated later code with a spurious StageHang
        with self._cond:
            if a.token not in self._armed:
                return
        self.fired += 1
        path = _scope_path()
        record = {
            "stage": a.stage,
            "path": path,
            "ceiling_s": round(a.ceiling_s, 3),
        }
        self.hangs.append(record)
        try:
            from .. import telemetry

            telemetry.event("stage-hang", **record)
        except Exception:
            pass
        try:
            from ..utils.logger import log_warning

            log_warning(
                f"watchdog: stage '{a.stage}' exceeded its hard ceiling "
                f"({a.ceiling_s:.1f} s) at scope '{path or '?'}' — "
                "raising StageHang"
                + ("" if a.interrupt else " (record only)")
            )
        except Exception:
            pass
        if a.notify is not None:
            try:
                a.notify({"type": "hang", "stage": a.stage, "path": path,
                          "ceiling_s": a.ceiling_s})
            except Exception:
                pass
        if a.interrupt:
            from .errors import StageHang

            with self._cond:
                if a.token not in self._armed:
                    return  # disarmed while we were recording
            _async_raise(a.thread_id, StageHang)


_wd: Optional[Watchdog] = None
_wd_lock = threading.Lock()


def _watchdog() -> Watchdog:
    global _wd
    with _wd_lock:
        if _wd is None:
            _wd = Watchdog()
        return _wd


class stage_guard:
    """Context manager arming the watchdog for one stage.  A None/zero
    ceiling is a complete no-op; on exit the stage is disarmed.  A
    ``StageHang`` that fired for THIS stage is enriched with the stage
    name / scope path / ceiling when it passes through."""

    def __init__(self, stage: str, ceiling_s: Optional[float], *,
                 interrupt: bool = True, notify=None) -> None:
        self.stage = stage
        self.ceiling_s = ceiling_s
        self.interrupt = interrupt
        self.notify = notify
        self._token: Optional[int] = None

    def __enter__(self):
        if self.ceiling_s and self.ceiling_s > 0:
            self._token = _watchdog().arm(
                self.stage, self.ceiling_s,
                interrupt=self.interrupt, notify=self.notify,
            )
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is None:
            # never armed (no ceiling): a StageHang passing through
            # belongs to some other guard — don't enrich it
            return False
        _watchdog().disarm(self._token)
        from .errors import StageHang

        if exc is not None and isinstance(exc, StageHang):
            if not exc.stage:
                exc.stage = self.stage
            if exc.ceiling_s is None:
                exc.ceiling_s = self.ceiling_s
            if not exc.scope_path:
                for rec in reversed(_watchdog().hangs):
                    if rec["stage"] == self.stage:
                        exc.scope_path = rec.get("path", "")
                        break
            if (not exc.args or not exc.args[0]
                    or exc.args[0] == type(exc).__name__):
                exc.args = (
                    f"stage '{self.stage}' exceeded its hard wall-clock "
                    f"ceiling ({self.ceiling_s}s) at scope "
                    f"'{exc.scope_path or '?'}'",
                )
        return False


def watchdog_stats() -> Dict[str, Any]:
    wd = _watchdog()
    return {"armed": int(wd.armed_total), "fired": int(wd.fired)}


def hang_log() -> List[dict]:
    return list(_watchdog().hangs)


def record_hang(record: dict) -> None:
    """Append an externally observed hang (the worker supervisor's
    SIGKILL path) to the same log the in-process watchdog writes."""
    wd = _watchdog()
    wd.fired += 1
    wd.hangs.append(dict(record))


# ---------------------------------------------------------------------------
# supervised workers
# ---------------------------------------------------------------------------


#: How many of the latest spawn, shipping and RSS readings a pool keeps.
RECENT_READINGS = 16


class _WorkerHandle:
    def __init__(self, proc, conn) -> None:
        self.proc = proc
        self.conn = conn
        self.requests = 0
        self.rss_bytes = 0
        self.threads = 0  # the worker's torch thread count (handshake)


class WorkerPool:
    """Spawned, warm-reusable compute workers for the serving layer.

    The execution model mirrors the service's (serial), so the pool
    holds ONE live worker and respawns it on death/recycle — the
    supervision structure (kill on hang, classify on crash, recycle on
    leak) is the point, not parallelism."""

    def __init__(self, max_requests: int = 32,
                 rss_limit_bytes: int = 4 << 30,
                 spool_dir: Optional[str] = None,
                 device: Any = "cuda") -> None:
        import tempfile

        self.max_requests = int(max_requests)
        self.rss_limit_bytes = int(rss_limit_bytes)
        self.device = str(device)
        self._own_spool = spool_dir is None
        self._spool = spool_dir or tempfile.mkdtemp(prefix="kmp-workers-")
        self._worker: Optional[_WorkerHandle] = None
        self._built = False
        self.stats = {"spawned": 0, "recycled": 0, "killed": 0,
                      "crashed": 0, "requests": 0}
        # the latest readings (a bounded window, so a long-lived service
        # keeps a constant footprint): seconds of each spawn handshake and
        # each graph shipped as npz (the price of the containment
        # boundary), each worker's RSS at its handshake (torch imported)
        # and after each served request
        self.spawn_seconds: collections.deque = collections.deque(
            maxlen=RECENT_READINGS)
        self.ship_seconds: collections.deque = collections.deque(
            maxlen=RECENT_READINGS)
        self.spawn_rss_bytes: collections.deque = collections.deque(
            maxlen=RECENT_READINGS)
        self.rss_bytes: collections.deque = collections.deque(
            maxlen=RECENT_READINGS)

    # -- lifecycle -----------------------------------------------------

    def _prebuild(self) -> None:
        """Build (or find built) the native libraries and, for a worker on
        the card, the kernels, before the first spawn: a cold worker then
        loads them from ``_build/`` instead of compiling its own copy."""
        if self._built:
            return
        from .. import native

        if shutil.which("g++") is not None:
            native.build()
        if self.device.startswith("cuda"):
            from .. import _native

            _native.build()
        self._built = True

    def _spawn(self) -> _WorkerHandle:
        import multiprocessing as mp

        import torch

        self._prebuild()
        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        t0 = time.perf_counter()
        proc = ctx.Process(
            target=_worker_entry,
            args=(child_conn, self._spool, torch.get_num_threads()),
            name="kmp-worker", daemon=True,
        )
        proc.start()
        child_conn.close()
        handle = _WorkerHandle(proc, parent_conn)
        self.stats["spawned"] += 1
        from .errors import WorkerCrash

        try:
            if not parent_conn.poll(WORKER_SPAWN_TIMEOUT_S):
                raise EOFError("spawn handshake timeout")
            ready = parent_conn.recv()
            if not isinstance(ready, dict) or ready.get("type") != "ready":
                raise EOFError(f"bad handshake message: {ready!r}")
            handle.threads = int(ready.get("threads") or 0)
            self.spawn_rss_bytes.append(int(ready.get("rss_bytes") or 0))
        except (EOFError, OSError) as e:
            proc.kill()
            proc.join(5)
            self.stats["crashed"] += 1
            raise WorkerCrash(
                f"worker pid {proc.pid} failed its spawn handshake "
                f"({e}; exit code {proc.exitcode})", site="worker-crash",
            ) from e
        self.spawn_seconds.append(time.perf_counter() - t0)
        _event("spawn", pid=proc.pid)
        return handle

    def _ensure_worker(self) -> _WorkerHandle:
        if self._worker is not None and self._worker.proc.is_alive():
            return self._worker
        self._worker = self._spawn()
        return self._worker

    def _drop_worker(self, *, kill: bool) -> None:
        w = self._worker
        self._worker = None
        if w is None:
            return
        try:
            if kill:
                w.proc.kill()
            elif w.proc.is_alive():
                try:
                    w.conn.send({"type": "exit"})
                except (OSError, ValueError, BrokenPipeError):
                    w.proc.terminate()
            w.proc.join(5)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(5)
        finally:
            try:
                w.conn.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        self._drop_worker(kill=False)
        if self._own_spool:
            shutil.rmtree(self._spool, ignore_errors=True)

    # -- request path --------------------------------------------------

    def run_request(self, request_id: str, source, graph, ctx,
                    k: int, epsilon: float, seed: Optional[int],
                    ceiling_s: Optional[float], trace: bool = False):
        """Run one request in the supervised worker.  Returns
        ``(partition ndarray, info dict)``; raises StageHang (site
        ``worker-hang``) on a hang-kill, WorkerCrash on a worker death,
        and the *re-raised classified type* for marshalled in-worker
        failures (a ladder-retryable DeviceOOM stays a retryable
        DeviceOOM — it must never read as a crash).  With ``trace``
        set, the worker marshals its depth-1 telemetry spans back as
        ``trace_spans`` rows on the result (telemetry/tracing.py's
        worker-boundary contract)."""
        from . import faults
        from .errors import StageHang, WorkerCrash

        # chaos directives (parent-side counters: deterministic across
        # worker respawns): an injected fault at these sites makes the
        # CHILD genuinely hang/die — the supervisor machinery is what
        # is under test, so the failure must be real
        chaos = None
        try:
            faults.maybe_inject("worker-hang")
        except StageHang:
            chaos = "hang"
        try:
            faults.maybe_inject("worker-crash")
        except WorkerCrash:
            chaos = chaos or "crash"
        if chaos == "hang" and not ceiling_s:
            # no hard ceiling means the supervisor would wait forever —
            # a chaos-plan typo must fail the request fast, not hang CI
            raise StageHang(
                f"injected worker-hang for request {request_id}, but no "
                "hard ceiling is armed (set hard_deadline_s / "
                f"{ENV_HARD_DEADLINE_S}) — failing fast instead of "
                "hanging the supervisor", site="worker-hang",
                injected=True,
            )

        worker = self._ensure_worker()
        result_path = os.path.join(self._spool, f"{request_id}-part.npz")
        ship_path: Optional[str] = None
        if isinstance(source, str):
            graph_ref = {"kind": "source", "value": source}
        else:
            t_ship = time.perf_counter()
            ship_path = self._ship_graph(request_id, graph)
            self.ship_seconds.append(time.perf_counter() - t_ship)
            graph_ref = {"kind": "npz", "value": ship_path}
        from .. import _native
        from ..context import context_to_dict

        try:
            try:
                worker.conn.send({
                    "type": "request",
                    "id": request_id,
                    "graph": graph_ref,
                    "ctx": context_to_dict(ctx),
                    "k": int(k),
                    "epsilon": float(epsilon),
                    "seed": int(seed) if seed is not None else None,
                    "ceiling_s": float(ceiling_s) if ceiling_s else None,
                    "chaos": chaos,
                    "result_path": result_path,
                    "trace": bool(trace),
                    "device": self.device,
                    # a caller timing its launches (_native.EVENT_LOG set)
                    # has the worker time this request's launches too
                    "time_kernels": _native.EVENT_LOG is not None,
                })
            except (OSError, ValueError, BrokenPipeError):
                # the worker died between the liveness check and the send
                return self._crash(worker, request_id)
            t0 = time.monotonic()
            kill_after = (
                ceiling_s + _kill_grace(ceiling_s) if ceiling_s else None
            )
            hang_note: Optional[dict] = None
            while True:
                try:
                    has_msg = worker.conn.poll(_TICK_S)
                except (OSError, EOFError):
                    return self._crash(worker, request_id)
                if has_msg:
                    try:
                        reply = worker.conn.recv()
                    except (EOFError, OSError):
                        return self._crash(worker, request_id)
                    kind = reply.get("type")
                    if kind == "hang":
                        # child watchdog noticed; wait for its graceful
                        # in-child raise until kill_after
                        hang_note = reply
                        continue
                    if kind == "result":
                        return self._finish(worker, request_id, reply)
                    if kind == "error":
                        self.stats["requests"] += 1
                        worker.requests += 1
                        if reply.get("error") == "StageHang":
                            # the child's OWN watchdog converted the
                            # hang gracefully (async raise landed) —
                            # the worker survives, but the hang still
                            # goes on record
                            record_hang({
                                "stage": reply.get("stage")
                                or "worker-compute",
                                "path": reply.get("scope_path", ""),
                                "ceiling_s": reply.get("ceiling_s"),
                                "request": request_id,
                                "worker_pid": worker.proc.pid,
                            })
                        self._maybe_recycle(worker)
                        heartbeat_touch()
                        _raise_marshalled(reply)
                    continue  # unknown message kinds are skipped
                if not worker.proc.is_alive():
                    return self._crash(worker, request_id)
                if (
                    kill_after is not None
                    and time.monotonic() - t0 > kill_after
                ):
                    return self._hang_kill(
                        worker, request_id, ceiling_s, hang_note
                    )
        finally:
            # the shipped graph npz is per-request scratch: every exit
            # path (result, crash, hang-kill, marshalled re-raise) is
            # done with it here — a long-lived service must not leak a
            # CSR copy to the spool per request
            if ship_path is not None:
                try:
                    os.unlink(ship_path)
                except OSError:
                    pass

    def _ship_graph(self, request_id: str, graph) -> str:
        import numpy as np

        from ..io.snapshot import write_snapshot

        if not (hasattr(graph, "xadj") and hasattr(graph, "adjncy")):
            # compressed containers / streamed spec wrappers arrive as
            # path/spec strings through the serving layer and take the
            # source branch; a bare exotic object has no cheap exchange
            # format — fail the request with an input-shaped error
            raise ValueError(
                "process isolation needs a CSR graph object or a "
                f"path/spec string, got {type(graph).__name__}"
            )
        arrays = {
            "xadj": np.asarray(graph.xadj),
            "adjncy": np.asarray(graph.adjncy),
        }
        if getattr(graph, "node_weights", None) is not None:
            arrays["node_weights"] = np.asarray(graph.node_weights)
        if getattr(graph, "edge_weights", None) is not None:
            arrays["edge_weights"] = np.asarray(graph.edge_weights)
        path = os.path.join(self._spool, f"{request_id}-graph.npz")
        write_snapshot(path, arrays)
        return path

    def _finish(self, worker: _WorkerHandle, request_id: str, reply: dict):
        import numpy as np

        from ..io.snapshot import SnapshotError, read_snapshot
        from . import integrity

        # `worker-reply-corrupt` chaos mutates the spool file after the
        # worker wrote it; the digest the reply carries is what the
        # parent-side verification catches it with.  A mismatch is a
        # classified IntegrityViolation (`corrupt-result` taxonomy at
        # the serving layer), NOT malformed-input — the worker finished
        # cleanly, the bytes rotted in the exchange.
        integrity.chaos_flip_file("worker-reply-corrupt", reply["path"])
        expect = (
            reply.get("sha256") if integrity.enabled() else None
        )
        try:
            part = np.asarray(
                read_snapshot(reply["path"], expect)["partition"],
                dtype=np.int32,
            )
        except (SnapshotError, ValueError) as exc:
            # keep the worker bookkeeping honest before propagating:
            # the worker itself behaved, only the reply bytes are bad
            try:
                os.unlink(reply["path"])
            except OSError:
                pass
            worker.requests += 1
            self.stats["requests"] += 1
            self._maybe_recycle(worker)
            heartbeat_touch()
            raise integrity.note_digest_mismatch(
                f"worker-reply:{request_id}", str(exc),
                site="worker-reply-corrupt",
            ) from exc
        try:
            os.unlink(reply["path"])
        except OSError:
            pass
        worker.requests += 1
        worker.rss_bytes = int(reply.get("rss_bytes") or 0)
        self.rss_bytes.append(worker.rss_bytes)
        self.stats["requests"] += 1
        self._maybe_recycle(worker)
        heartbeat_touch()
        return part, reply

    def _maybe_recycle(self, worker: _WorkerHandle) -> None:
        over_count = worker.requests >= self.max_requests
        over_rss = (
            self.rss_limit_bytes > 0
            and worker.rss_bytes > self.rss_limit_bytes
        )
        if not (over_count or over_rss):
            return
        self.stats["recycled"] += 1
        _event(
            "recycle", pid=worker.proc.pid, requests=worker.requests,
            rss_bytes=worker.rss_bytes,
            reason="rss-watermark" if over_rss else "max-requests",
        )
        self._drop_worker(kill=False)

    def _crash(self, worker: _WorkerHandle, request_id: str):
        from .errors import WorkerCrash

        pid = worker.proc.pid
        worker.proc.join(5)
        code = worker.proc.exitcode
        self._drop_worker(kill=True)
        self.stats["crashed"] += 1
        self.stats["requests"] += 1
        _event("crash", pid=pid, exit_code=code, request=request_id)
        heartbeat_touch()
        exc = WorkerCrash(
            f"worker pid {pid} died (exit code {code}) serving request "
            f"{request_id}", site="worker-crash",
        )
        exc.exit_code = code
        raise exc

    def _hang_kill(self, worker: _WorkerHandle, request_id: str,
                   ceiling_s: float, hang_note: Optional[dict]):
        from .errors import StageHang

        pid = worker.proc.pid
        path = (hang_note or {}).get("path", "")
        stage = (hang_note or {}).get("stage", "worker-compute")
        self._drop_worker(kill=True)
        self.stats["killed"] += 1
        self.stats["requests"] += 1
        record = {
            "stage": stage, "path": path,
            "ceiling_s": round(float(ceiling_s), 3),
            "request": request_id, "worker_pid": pid,
        }
        record_hang(record)
        _event("hang-kill", **record)
        heartbeat_touch()
        exc = StageHang(
            f"worker pid {pid} exceeded the hard wall-clock ceiling "
            f"({ceiling_s}s) serving request {request_id} "
            f"(stuck at '{path or stage}'); SIGKILLed",
            site="worker-hang", stage=stage, scope_path=path,
            ceiling_s=float(ceiling_s),
        )
        raise exc


def _event(action: str, **attrs) -> None:
    try:
        from .. import telemetry

        telemetry.event("supervision", action=action, **attrs)
    except Exception:
        pass


def _raise_marshalled(reply: dict) -> None:
    """Re-raise a worker-marshalled failure as its own type, so the
    parent's isolation boundary classifies it exactly as it would have
    in-process (the retryable-OOM / breaker contract)."""
    name = reply.get("error", "RuntimeError")
    detail = reply.get("detail", "")
    from . import errors as res_errors

    cls = getattr(res_errors, name, None)
    if isinstance(cls, type) and issubclass(cls, res_errors.DegradationError):
        exc = cls(detail, site=reply.get("site") or None)
        if isinstance(exc, res_errors.DeviceOOM):
            exc.rungs_exhausted = bool(reply.get("rungs_exhausted"))
        if isinstance(exc, res_errors.StageHang):
            exc.stage = reply.get("stage", "")
            exc.scope_path = reply.get("scope_path", "")
            exc.ceiling_s = reply.get("ceiling_s")
        raise exc
    if name == "GraphFormatError":
        from ..io.errors import GraphFormatError

        raise GraphFormatError(detail)
    import builtins

    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, Exception):
        raise cls(detail)
    raise RuntimeError(f"{name}: {detail}")


# ---------------------------------------------------------------------------
# the worker child
# ---------------------------------------------------------------------------


def _worker_entry(conn, spool: str, threads: int = 1) -> None:
    """Worker-subprocess main loop.  Chaos directives (and the exit
    message) are handled before any partitioning import, so a
    crash-injected worker dies at once.  The worker's torch thread count
    is its parent's (``threads``), so workers of parallel test processes
    do not oversubscribe the host."""
    import signal

    import torch

    torch.set_num_threads(max(1, int(threads)))
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent drains
    except (ValueError, OSError):
        pass
    # the watchdog's hang notify fires from its own thread while the
    # main thread may be mid-send in a pathological interleaving — one
    # lock serializes every write to the pipe
    send_lock = threading.Lock()

    def send(payload) -> None:
        with send_lock:
            conn.send(payload)

    send({"type": "ready", "pid": os.getpid(),
          "threads": torch.get_num_threads(), "rss_bytes": _self_rss_bytes()})
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            return
        if not isinstance(msg, dict) or msg.get("type") == "exit":
            return
        chaos = msg.get("chaos")
        if chaos == "crash":
            # the native-segfault stand-in: die without any cleanup
            os.kill(os.getpid(), signal.SIGKILL)
        if chaos == "hang":
            # a dead-stuck launch: never answer, never exit — the
            # supervisor's SIGKILL is the only way out
            while True:
                time.sleep(0.5)
        try:
            send(_worker_compute(msg, send))
        except BaseException as exc:  # marshal everything; keep serving
            try:
                send(_marshal_error(exc))
            except (OSError, ValueError, BrokenPipeError):
                return


def _marshal_error(exc: BaseException) -> dict:
    from . import errors as res_errors

    err = res_errors.classify(exc, site="")
    reply = {
        "type": "error",
        "error": type(err if err is not None else exc).__name__,
        "detail": str(exc)[:300],
        "site": getattr(err, "site", "") if err is not None else "",
    }
    if isinstance(err, res_errors.DeviceOOM):
        reply["rungs_exhausted"] = bool(err.rungs_exhausted)
    if isinstance(err, res_errors.StageHang):
        reply["stage"] = err.stage
        reply["scope_path"] = err.scope_path
        reply["ceiling_s"] = err.ceiling_s
    return reply


def _worker_compute(msg: dict, send) -> dict:
    import time as _time

    import numpy as np
    import torch

    from .. import _native, telemetry
    from ..cli import apply_dict_to_context
    from ..context import Context
    from ..device import resolve_device
    from ..io.snapshot import write_snapshot
    from ..kaminpar import KaMinPar
    from ..utils import timer
    from ..utils.logger import OutputLevel

    t0 = _time.perf_counter()
    # raises (a marshalled RuntimeError) when the card cannot be reached:
    # a worker never carries on on the CPU in place of the card
    device = resolve_device(msg.get("device", "cuda"))
    ctx = Context()
    apply_dict_to_context(ctx, msg["ctx"])
    graph = _child_graph(msg["graph"])
    telemetry.reset()
    telemetry.enable()
    solver = KaMinPar(ctx, device=device)
    solver.set_output_level(OutputLevel.QUIET)
    solver.set_graph(graph)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    timed = on_card and bool(msg.get("time_kernels"))
    if timed:
        _native.EVENT_LOG = {}
    launches0 = telemetry.kernel_launches()
    try:
        with stage_guard(
            "worker-compute", msg.get("ceiling_s"), notify=send,
        ):
            part = solver.compute_partition(
                k=msg["k"], epsilon=msg["epsilon"], seed=msg.get("seed"),
            )
    finally:
        log = _native.EVENT_LOG
        _native.EVENT_LOG = None
    launches1 = telemetry.kernel_launches()
    kernel_ms = None
    if timed:
        torch.cuda.synchronize(device)
        kernel_ms = {name: sum(a.elapsed_time(b) for a, b in log.get(name, ()))
                     for name in launches1}
    gate_s = timer.GLOBAL_TIMER.elapsed("output-gate")
    metrics = solver.result_metrics(graph, part)
    gate = telemetry.run_info().get("output_gate")
    gate_valid = (
        bool(gate.get("valid"))
        if isinstance(gate, dict) and gate.get("checked") else None
    )
    degraded = sorted({
        e.attrs.get("site", "") for e in telemetry.events("degraded")
    } - {""})
    _, result_sha = write_snapshot(
        msg["result_path"],
        {"partition": np.asarray(part, dtype=np.int32)},
    )
    wall_s = _time.perf_counter() - t0
    # the worker's own span rows for the request trace: its depth-1
    # telemetry scopes plus one whole-compute row, all worker-relative
    # ms; the parent re-bases them (tracing.record_worker_reply)
    trace_spans = None
    if msg.get("trace"):
        from ..telemetry import tracing

        trace_spans = tracing.harvest_worker_rows()
        trace_spans.insert(0, {
            "name": "worker-compute",
            "origin": "worker",
            "start_ms": 0.0,
            "duration_ms": round(wall_s * 1000.0, 3),
            "attrs": {"worker_pid": os.getpid()},
        })
    return {
        "type": "result",
        "path": msg["result_path"],
        # content digest of the written reply file: the parent verifies
        # it on re-read, so spool-file corruption cannot serve silently
        "sha256": result_sha,
        "metrics": {
            "cut": int(metrics["cut"]),
            "imbalance": float(metrics["imbalance"]),
            "feasible": bool(metrics["feasible"]),
        },
        "gate_valid": gate_valid,
        "gate_s": float(gate_s),
        "degraded_sites": degraded,
        "anytime": solver.last_anytime,
        "rss_bytes": _self_rss_bytes(),
        "device_peak_bytes": (
            int(torch.cuda.max_memory_allocated(device)) if on_card
            else 0
        ),
        "wall_s": wall_s,
        "trace_spans": trace_spans,
        # where the JAX worker ships its execution-ledger summary: this
        # request's launches of each hand-written kernel in the worker
        "ledger": {name: launches1[name] - launches0.get(name, 0)
                   for name in launches1},
        # beside it, where the parent asked: those launches' summed
        # CUDA-event milliseconds; None where they were not timed
        "kernel_ms": kernel_ms,
    }


def _child_graph(ref: dict):
    if ref["kind"] == "npz":
        from ..graphs.host import HostGraph
        from ..io.snapshot import read_snapshot

        arrays = read_snapshot(ref["value"])
        return HostGraph(
            arrays["xadj"], arrays["adjncy"],
            arrays.get("node_weights"), arrays.get("edge_weights"),
        )
    src = ref["value"]
    if src.startswith("gen:"):
        from ..graphs.factories import generate

        return generate(src)
    from .. import io as io_mod

    return io_mod.load_graph(src)


def _self_rss_bytes() -> int:
    """The worker's own resident set: its peak (VmHWM of
    /proc/self/status), or, where the kernel reports no peak, its current
    VmRSS.  Not ``ru_maxrss``, which Linux keeps across ``execve``: a
    spawned worker's would be at least its parent's RSS at the fork (the
    JAX package's copy reads it, so its workers report their parent's
    size)."""
    fields = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("VmHWM", "VmRSS"):
                    fields[key] = int(value.split()[0]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    if fields:
        return fields.get("VmHWM", fields.get("VmRSS", 0))
    try:
        import resource

        return int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        )
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# report surface
# ---------------------------------------------------------------------------


def summary(pool: Optional[WorkerPool] = None,
            isolation: Optional[str] = None) -> Dict[str, Any]:
    """The run report's ``supervision`` section (schema v10).  Returns
    the well-formed disabled default for a run that configured nothing
    — no pool, no heartbeat, never an armed watchdog stage."""
    wd = _watchdog()
    hb = heartbeat_state()
    enabled = (
        pool is not None
        or bool(hb["file"])
        or wd.armed_total > 0
        or bool(wd.hangs)
    )
    if not enabled:
        return {"enabled": False}
    workers = (
        dict(pool.stats) if pool is not None
        else {"spawned": 0, "recycled": 0, "killed": 0, "crashed": 0,
              "requests": 0}
    )
    return {
        "enabled": True,
        "isolation": isolation or ("process" if pool else "inproc"),
        "workers": workers,
        "hangs": hang_log(),
        "heartbeat": {"file": hb["file"] or "", "count": hb["count"]},
        "watchdog": watchdog_stats(),
    }


def reset() -> None:
    """Clear watchdog/heartbeat statistics and configuration (test
    isolation).  Live WorkerPools are owned by their services and are
    not touched."""
    global _hb_path, _hb_count
    wd = _watchdog()
    with wd._cond:
        wd._armed.clear()
        wd.armed_total = 0
        wd.fired = 0
        wd.hangs = []
        wd._cond.notify()
    with _hb_lock:
        _hb_path = None
        _hb_count = 0
