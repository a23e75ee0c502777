"""The port's degradation contract against the JAX package's, at zero
tolerance: the fault-site registry, the plan grammar and its seeded draws,
`with_fallback`'s events and circuit breakers, `classify` on a real torch
out-of-memory error, the deadline's unit behaviour, and every injection
site of the single-device path end to end (the same plan gives the same
partition and the same `degraded` events in both packages).

`run_pair` is the resilience files' shared harness: it runs one graph
through both facades under one environment (fault plan, stop point, forced
rung, kill switches) and returns both partitions and both event streams.
"""

import contextlib
import os
import signal

import numpy as np
import pytest
import torch

import kaminpar_tpu as kt
import kaminpar_tpu_torch as kp
from kaminpar_tpu import resilience as jres
from kaminpar_tpu import telemetry as jtel
from kaminpar_tpu.graphs import factories as jfactories
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.resilience import deadline as jdeadline
from kaminpar_tpu.resilience import faults as jfaults
from kaminpar_tpu.resilience import policy as jpolicy
from kaminpar_tpu.utils import rng as jrng
from kaminpar_tpu_torch import resilience as tres
from kaminpar_tpu_torch import telemetry as ttel
from kaminpar_tpu_torch.resilience import deadline as tdeadline
from kaminpar_tpu_torch.resilience import errors as terrors
from kaminpar_tpu_torch.resilience import faults as tfaults
from kaminpar_tpu_torch.resilience import policy as tpolicy
from kaminpar_tpu_torch.utils import rng as trng
from test_torch_schemes import port_context
from torch_threads import one_torch_thread  # noqa: F401

#: Every variable that steers the resilience layer in either package.
ENV_VARS = (
    "KAMINPAR_TPU_FAULTS", "KAMINPAR_TPU_STOP_AT", "KAMINPAR_TPU_MEM_RUNG",
    "KAMINPAR_TPU_MEM_GOVERNOR", "KAMINPAR_TPU_HBM_BYTES",
    "KAMINPAR_TPU_INTEGRITY", "KAMINPAR_TPU_AUDIT_FRACTION",
    "KAMINPAR_TPU_NO_NATIVE_IP", "KAMINPAR_TPU_NO_NATIVE_FM",
    "KAMINPAR_TPU_SIM_RANK",
)

#: The attributes of a `degraded` event both packages must agree on.
DEGRADED_KEYS = ("site", "error", "detail", "fallback", "attempts",
                 "breaker_open", "injected", "recovered", "where", "rung",
                 "rung_name")


def reset_both():
    jres.reset()
    tres.reset()
    jtel.reset()
    ttel.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    reset_both()
    yield
    reset_both()
    jtel.disable()
    ttel.disable()


@contextlib.contextmanager
def environment(env):
    """Set `env` (name -> value) for the block, restoring it after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_graph(host):
    return kp.HostGraph(host.xadj, host.adjncy, host.node_weights,
                        host.edge_weights)


def events(tel, name):
    return [dict(e.attrs) for e in tel.events(name)]


def degraded(tel):
    return [{k: e.get(k) for k in DEGRADED_KEYS} for e in
            events(tel, "degraded")]


class Run:
    """One package's run: its partition (or the exception it raised), the
    solver, and the events it left."""

    def __init__(self, part, solver, tel, error=None):
        self.part = part
        self.solver = solver
        self.error = error
        self.events = {name: events(tel, name) for name in (
            "degraded", "memory-budget", "deadline", "resume", "checkpoint",
            "integrity", "refine-skipped", "memory-spill", "memory-reload",
            "semi-external", "host-only-partition", "stream")}
        self.degraded = degraded(tel)


def run_one(package, preset, host, k, env=None, configure=None,
            ckdir=None, resume=False, contraction_limit=160, seed=1):
    """Run one package's facade; configure(ctx) edits the JAX context
    before the port's is made from it (both get the same knobs)."""
    jctx = jax_preset(preset)
    jctx.coarsening.contraction_limit = contraction_limit
    if configure is not None:
        configure(jctx)
    if ckdir is not None:
        jctx.resilience.checkpoint_dir = str(ckdir)
        jctx.resilience.resume = resume
    if package == "jax":
        jres.reset()
        jtel.reset()
        jtel.enable()
        ctx, tel = jctx, jtel
        solver = kt.KaMinPar(ctx)
        graph = host
    else:
        tres.reset()
        ttel.reset()
        ttel.enable()
        ctx, tel = port_context(jctx), ttel
        solver = kp.KaMinPar(ctx, device="cpu")
        graph = port_graph(host)
    solver.set_output_level(0)
    solver.set_graph(graph)
    with environment(env or {}):
        try:
            part = np.asarray(solver.compute_partition(
                k=k, epsilon=0.03, seed=seed))
        except Exception as exc:  # noqa: BLE001 — compared across packages
            return Run(None, solver, tel, error=exc)
    return Run(part, solver, tel)


def run_pair(preset, host, k, env=None, configure=None, ckdirs=None,
             resume=False, **kw):
    """(JAX run, port run) of one graph under one environment; `ckdirs`
    gives each package its own checkpoint directory."""
    ckdirs = ckdirs or (None, None)
    j = run_one("jax", preset, host, k, env, configure, ckdirs[0], resume,
                **kw)
    t = run_one("port", preset, host, k, env, configure, ckdirs[1], resume,
                **kw)
    return j, t


def assert_same(j, t, skip=()):
    """Both runs raised the same error, or both gave the same partition;
    and both recorded the same `degraded` events (less the attributes in
    `skip`: a detail that names a checkpoint path or a context
    fingerprint differs between the packages)."""
    assert (j.error is None) == (t.error is None), (j.error, t.error)
    if j.error is not None:
        assert type(j.error).__name__ == type(t.error).__name__
        assert str(j.error) == str(t.error)
        return
    assert t.part.dtype == np.int32
    np.testing.assert_array_equal(j.part, t.part)

    def kept(events):
        return [{k: v for k, v in e.items() if k not in skip}
                for e in events]

    assert kept(j.degraded) == kept(t.degraded)


@pytest.fixture(scope="module")
def small():
    """A 2^12-node RMAT graph with edge weights and isolated nodes."""
    return jfactories.make_rmat(1 << 12, 30_000, seed=3)


# --- registry, plans, draws ------------------------------------------------


def test_site_registry_equal():
    assert list(tfaults.SITES) == list(jfaults.SITES)
    for name, spec in jfaults.SITES.items():
        mine = tfaults.SITES[name]
        assert mine.exc.__name__ == spec.exc.__name__
        assert mine.fallback == spec.fallback
        assert mine.description == spec.description
        assert mine.exc.breaker_relevant == spec.exc.breaker_relevant


@pytest.mark.parametrize("plan", [
    "device-oom:nth=1", "native-ip,native-fm:nth=2", "all:nth=1",
    "refiner:0.25", "bit-flip:partition:nth=1", "bit-flip:contraction",
    "device-oom@rank=1:nth=1", " refiner : always , collective ",
    "no-such-site", "device-oom:nth=0", "refiner:1.5", "refiner:often",
    "device-oom@node=1", "device-oom@rank=x", "device-oom@rank=-1",
])
def test_parse_plan_equal(plan):
    try:
        want = [vars(r) for r in jfaults.parse_plan(plan)]
    except jfaults.FaultPlanError as exc:
        with pytest.raises(tfaults.FaultPlanError) as got:
            tfaults.parse_plan(plan)
        assert str(got.value) == str(exc)
        return
    assert [vars(r) for r in tfaults.parse_plan(plan)] == want


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_seeded_draws_equal(seed):
    jrng.set_seed(seed)
    trng.set_seed(seed)
    for site in ("refiner", "device-oom", "bit-flip:partition"):
        for count in range(1, 40):
            assert (tfaults._seeded_draw(site, count)
                    == jfaults._seeded_draw(site, count))


@pytest.mark.parametrize("plan", [
    "refiner:0.3,device-oom:nth=4", "all:0.5", "native-ip:always",
    "device-oom@rank=0:nth=2", "device-oom@rank=1:nth=2",
])
def test_injection_fires_at_the_same_calls(plan, monkeypatch):
    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", plan)
    jrng.set_seed(7)
    trng.set_seed(7)
    for pkg in (jfaults, tfaults):
        for i in range(60):
            site = ("refiner", "device-oom", "native-ip",
                    "bit-flip:partition")[i % 4]
            try:
                pkg.maybe_inject(site)
            except Exception as exc:  # noqa: BLE001
                assert exc.injected and exc.site == site
    assert tfaults.injected_log() == jfaults.injected_log()
    assert tfaults.plan_summary() == jfaults.plan_summary()


# --- with_fallback and the breakers ----------------------------------------


def _fallback_script(policy, errors, tel):
    """A fixed sequence of guarded calls; returns their results, the
    events and the breakers."""
    tel.reset()
    tel.enable()
    out = []

    def fail(exc):
        def primary():
            raise exc
        return primary

    calls = 0

    def flaky():
        nonlocal calls
        calls += 1
        if calls == 1:
            raise errors.DeviceOOM("transient")
        return "primary"

    out.append(policy.with_fallback(lambda: "primary", lambda e: "fb",
                                    site="refiner"))
    out.append(policy.with_fallback(flaky, lambda e: "fb", site="refiner",
                                    retries=1, where="w"))
    for _ in range(2):
        out.append(policy.with_fallback(
            fail(errors.RefinerRefused("no")), lambda e: "fb",
            site="native-fm"))
    for _ in range(4):
        out.append(policy.with_fallback(
            fail(MemoryError("host")), lambda e: type(e).__name__
            if e is not None else None, site="device-balancer",
            where="level0"))
    try:
        policy.with_fallback(fail(ValueError("bug")), lambda e: "fb",
                             site="refiner")
    except ValueError as exc:
        out.append(f"raised {exc}")
    try:
        policy.with_fallback(fail(errors.IntegrityViolation("bad")),
                             lambda e: "fb", site="refiner")
    except errors.IntegrityViolation:
        out.append("integrity raised")
    try:
        policy.with_fallback(fail(RuntimeError("CUDA out of memory")), None,
                             site="compressed-stream")
    except errors.DeviceOOM as exc:
        out.append(f"oom {exc.site}")
    breakers = {s: policy.breaker_state(s) for s in (
        "refiner", "native-fm", "device-balancer", "compressed-stream")}
    return out, degraded(tel), breakers


def test_with_fallback_events_and_breakers_equal():
    from kaminpar_tpu.resilience import errors as jerrors

    want = _fallback_script(jpolicy, jerrors, jtel)
    got = _fallback_script(tpolicy, terrors, ttel)
    assert got == want
    assert got[2]["device-balancer"]["open"]
    assert not got[2]["native-fm"]["open"]


def test_classify_a_torch_out_of_memory_error():
    """A real CUDA allocation failure surfaces in torch as
    torch.OutOfMemoryError, a RuntimeError: it classifies as DeviceOOM
    whose cause is the torch exception."""
    exc = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.10 GiB of which 1.25 GiB is free.")
    assert isinstance(exc, RuntimeError)
    err = terrors.classify(exc, "device-oom")
    assert isinstance(err, terrors.DeviceOOM)
    assert err.site == "device-oom" and err.__cause__ is exc
    assert not err.injected and not err.rungs_exhausted
    # the same text classifies the same way in the JAX package
    from kaminpar_tpu.resilience import errors as jerrors

    assert isinstance(jerrors.classify(RuntimeError(str(exc)), "x"),
                      jerrors.DeviceOOM)
    assert terrors.classify(ValueError("shape mismatch"), "x") is None
    host = terrors.classify(MemoryError("malloc"), "y")
    assert isinstance(host, terrors.DeviceOOM) and host.site == "y"
    passed = terrors.RefinerRefused("no")
    assert terrors.classify(passed, "native-fm") is passed
    assert passed.site == "native-fm"


# --- deadline ---------------------------------------------------------------


def test_deadline_unit_behaviour_equal():
    def script(deadline):
        deadline.clear()
        out = [deadline.should_stop(), deadline.triggered()]
        deadline.begin_run(None)
        deadline.note_stage("coarsen:1")
        out.append(deadline.should_stop())
        deadline.request_stop("test")
        out += [deadline.should_stop(), deadline.stage_reached()]
        st = deadline.state()
        st.pop("elapsed_s", None)
        out.append(st)
        deadline.begin_run(1e-9, 5.0)
        out.append(deadline.should_stop())
        st = deadline.state()
        st.pop("elapsed_s", None)
        out.append(st)
        deadline.request_stop("sigterm")
        out.append(deadline.draining())
        deadline.begin_run(None)  # a signal survives into the next run
        out += [deadline.should_stop(), deadline.state()["reason"]]
        deadline.clear()
        out += [deadline.draining(), deadline.should_stop()]
        return out

    assert script(tdeadline) == script(jdeadline)


def test_signal_handler_requests_a_stop():
    """The installed SIGTERM handler, called as a delivery would call it,
    requests a process-wide stop and gives the signal back to its
    previous handler (a second delivery would kill)."""
    import threading

    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers can only be installed from the main "
                    "thread")
    previous = signal.getsignal(signal.SIGTERM)
    tdeadline.clear()
    tdeadline.install_signal_handlers()
    try:
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not previous
        handler(signal.SIGTERM, None)
        assert tdeadline.should_stop()
        assert tdeadline.draining() == "sigterm"
        assert signal.getsignal(signal.SIGTERM) is previous
    finally:
        tdeadline.uninstall_signal_handlers()
        tdeadline.clear()


def test_expired_budget_gives_the_same_anytime_partition(small):
    """A budget that has expired before the first barrier winds both
    packages down at `coarsen:1`: the same reduced-effort partition."""
    def configure(ctx):
        ctx.resilience.time_budget = 1e-9

    j, t = run_pair("default", small, 8, configure=configure)
    assert_same(j, t)
    jt, tt = j.solver.last_anytime, t.solver.last_anytime
    assert tt["anytime"] and tt["reason"] == "budget"
    assert {k: tt[k] for k in ("anytime", "reason", "stage", "budget_s",
                               "grace_s")} == {
        k: jt[k] for k in ("anytime", "reason", "stage", "budget_s",
                           "grace_s")}
    assert [e["algorithm"] for e in t.events["refine-skipped"]] == [
        e["algorithm"] for e in j.events["refine-skipped"]]


# --- the injection sites end to end -----------------------------------------


@pytest.mark.parametrize("preset,plan", [
    ("default", "native-ip:nth=1"),
    ("default", "native-ip"),
    ("strong", "native-fm:nth=1"),
    ("default", "refiner:nth=2"),
    ("default", "device-balancer:nth=1"),
    ("default", "refiner:0.3"),
    ("default", "all:nth=1"),
    ("terapart", "compressed-stream:nth=1"),
    ("terapart", "device-oom:nth=2"),
], ids=lambda v: v.replace(":", "-"))
def test_injection_site_bitwise(small, preset, plan):
    j, t = run_pair(preset, small, 8, env={"KAMINPAR_TPU_FAULTS": plan})
    assert_same(j, t)
    assert any(d["injected"] for d in t.degraded), "nothing injected"


def test_collective_site_degrades_the_report(small, monkeypatch):
    from kaminpar_tpu.telemetry import report as jreport
    from kaminpar_tpu_torch.telemetry import report as treport

    j, t = run_pair("default", small, 4)
    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "collective")
    jrep = jreport.build_run_report()
    trep = treport.build_run_report()
    assert "timers_aggregated" not in trep
    assert "timers_aggregated" not in jrep

    def sites(rep):
        return [{k: d["attrs"].get(k) for k in DEGRADED_KEYS}
                for d in rep["degraded"]]

    assert sites(trep) == sites(jrep)
    assert [d["site"] for d in sites(trep)] == ["collective"]
    assert trep["faults"] == jrep["faults"]
    assert not treport.validate_report(trep)


def test_compressed_fallback_decodes_once_per_graph(small, monkeypatch):
    """A seed sweep on a compressed graph whose chunked upload always
    fails decodes it once: the fallback shares `_decode_cached`."""
    from kaminpar_tpu_torch.graphs import compressed as tcomp

    monkeypatch.setenv("KAMINPAR_TPU_FAULTS", "compressed-stream")
    calls = []
    decode = tcomp.CompressedHostGraph.decode

    def counting(self):
        calls.append(self)
        return decode(self)

    monkeypatch.setattr(tcomp.CompressedHostGraph, "decode", counting)
    host = jfactories.make_rmat(1 << 10, 6_000, seed=5)
    solver = kp.KaMinPar("terapart", device="cpu").set_output_level(0)
    solver.set_graph(port_graph(host))
    for seed in (1, 2, 3):
        part = solver.compute_partition(k=4, epsilon=0.03, seed=seed)
        assert part.shape == (host.n,)
    assert len(calls) == 1
