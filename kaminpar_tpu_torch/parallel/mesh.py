"""The shard mesh and its collectives (counterpart of
kaminpar_tpu/parallel/mesh.py).

The JAX package runs every dist kernel under ``shard_map``: one body per
device of a ``jax.sharding.Mesh``, with ``psum`` / ``all_gather`` /
``all_to_all`` inside it, all in one process.  Torch has no SPMD
transform, so here a :class:`Mesh` is an ordered list of D shard slots,
each mapped to a ``torch.device`` (all ``cuda:0`` on one card, all
``cpu`` in the tests; shard d goes to ``devices[d % len(devices)]``), and
each JAX round body is split at its collectives into per-shard phases.
Between two collectives a shard's work depends on nothing of another
shard, so running the shards one after another gives the SPMD result
bitwise.  The collectives below take the per-shard tensors as a list in
shard order and copy across devices where shards live on different ones:

  * ``psum(xs)``: the elementwise sum (one replicated result);
  * ``all_gather(xs)``: the tiled all_gather, concatenated in shard order;
  * ``all_to_all(xs)``: the tiled all_to_all along axis 0 — shard d's
    block p lands in shard p's block d;
  * :func:`halo_exchange`: the interface-to-ghost exchange over the
    DistGraph's send/recv tables (one all_to_all of [C, D, s_max]).

The shard index is the row-major index of a (rows, cols) grid, which is
``lax.axis_index(("nodes_x", "nodes_y"))`` of the JAX package: a 1D mesh
is a (1, D) grid.

Communication accounting: the JAX package registers each collective at
trace time (once per traced program, per round of a loop body).  This
package executes eagerly, so it registers each call: a row is one
(phase, collective, payload shape) with its number of calls and the
payload bytes per device of one call.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..dtypes import ACC_DTYPE
from ..ops.segments import segment_sum

NODE_AXIS_X = "nodes_x"
NODE_AXIS_Y = "nodes_y"
NODE_AXIS = (NODE_AXIS_X, NODE_AXIS_Y)


class Mesh:
    """D shard slots on a (rows, cols) grid; slot d runs on
    ``devices[d]``.  ``device`` (slot 0's) holds the replicated arrays."""

    def __init__(self, devices: Sequence[torch.device],
                 shape: Tuple[int, int]):
        rows, cols = int(shape[0]), int(shape[1])
        if rows * cols != len(devices) or rows < 1 or cols < 1:
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(devices)} shards")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape = (rows, cols)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _default_devices(device: DeviceLike) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count > 1:
            return [torch.device("cuda", i) for i in range(count)]
    return [dev]


def make_mesh(
    n_devices: Optional[object] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = "cuda",
) -> Mesh:
    """A mesh of D shard slots: ``n_devices`` is an int D (a (1, D) grid),
    a (rows, cols) tuple, or None (one slot per device).  Slot d runs on
    ``devices[d % len(devices)]``; without ``devices``, on ``device``
    (every card when that is a bare ``"cuda"`` on a box with several)."""
    if devices is not None:
        base = [resolve_device(d) for d in devices]
        if not base:
            raise ValueError("devices must not be empty")
    else:
        base = _default_devices(device)
    if isinstance(n_devices, tuple):
        rows, cols = int(n_devices[0]), int(n_devices[1])
    elif n_devices is not None:
        rows, cols = 1, int(n_devices)
    else:
        rows, cols = 1, len(base)
    if rows < 1 or cols < 1:
        raise ValueError(f"bad mesh size {n_devices}")
    D = rows * cols
    return Mesh([base[d % len(base)] for d in range(D)], (rows, cols))


def make_torus_mesh(rows: int, cols: int, device: DeviceLike = "cuda",
                    devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (rows, cols) grid mesh — make_mesh((rows, cols))."""
    return make_mesh((rows, cols), devices=devices, device=device)


# --------------------------------------------------------------------------
# collectives over per-shard lists
# --------------------------------------------------------------------------


def psum(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Sum of the shards' tensors (integer sums are exact in any order)."""
    dev = xs[0].device if device is None else device
    out = xs[0].to(dev).clone()
    for x in xs[1:]:
        out += x.to(dev)
    return out


def all_gather(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The tiled all_gather: the shards' tensors concatenated in order."""
    dev = xs[0].device if device is None else device
    return torch.cat([x.to(dev) for x in xs])


def all_to_all(xs: Sequence[torch.Tensor],
               devices: Optional[Sequence[torch.device]] = None
               ) -> List[torch.Tensor]:
    """The tiled all_to_all along axis 0: each xs[d] is [D, ...]; shard
    p receives [xs[0][p], xs[1][p], ...] stacked in shard order."""
    D = len(xs)
    out = []
    for p in range(D):
        dev = xs[p].device if devices is None else devices[p]
        out.append(torch.stack([xs[d][p].to(dev) for d in range(D)]))
    return out


def throttled_local_capacity(
    targets: Sequence[torch.Tensor],
    node_ws: Sequence[torch.Tensor],
    weights: torch.Tensor,
    cap: torch.Tensor,
) -> List[torch.Tensor]:
    """Per-shard capacity shares (the control_cluster_weights analog): each
    shard's join demand per target is summed over the mesh, and a shard's
    share is its demand scaled by headroom/demand (exact when the demand
    fits), so the total accepted weight stays within the headroom."""
    C = cap.shape[0]
    demand_ls = [
        segment_sum(torch.where(t >= 0, nw, 0).to(ACC_DTYPE),
                    t.clamp(0, C - 1), C)
        for t, nw in zip(targets, node_ws)
    ]
    account_collective("psum(cluster-demand)", C * 4, shape=(C,))
    demand = psum(demand_ls, device=weights.device)
    headroom = (cap - weights.to(ACC_DTYPE)).clamp(min=0)
    frac = headroom.to(torch.float32) / demand.clamp(min=1).to(torch.float32)
    frac = torch.minimum(frac, frac.new_ones(()))
    fits = demand <= headroom
    out = []
    for demand_l in demand_ls:
        dev = demand_l.device
        scaled = torch.floor(
            demand_l.to(torch.float32) * frac.to(dev) * (1.0 - 1e-6)
        ).to(ACC_DTYPE)
        local = torch.where(fits.to(dev), demand_l, scaled)
        out.append(torch.minimum(local, headroom.to(dev)))
    return out


def halo_exchange(
    vals: Sequence[torch.Tensor],
    send_idx: Sequence[torch.Tensor],
    recv_map: Sequence[torch.Tensor],
    g_loc: int,
) -> List[torch.Tensor]:
    """Interface-to-ghost exchange: shard d sends peer p the values of its
    owned nodes send_idx[d][p] (pad -1), and peer p writes what arrives
    from d into its ghost slots recv_map[p][d] (pad g_loc, dropped).
    Each vals[d] is [n_loc] or stacked [C, n_loc]; returns [g_loc] or
    [C, g_loc] per shard."""
    stacked = vals[0].dim() == 2
    sendbufs = []
    for v, si in zip(vals, send_idx):
        v2 = v if stacked else v[None]
        n_loc = v2.shape[1]
        sendbufs.append(v2[:, si.clamp(0, n_loc - 1).to(torch.int64)])
    C, D, s_max = sendbufs[0].shape
    account_collective(
        "all_to_all(halo)", C * D * s_max * sendbufs[0].element_size(),
        shape=(C, D, s_max),
    )
    out = []
    for p in range(D):
        dev = sendbufs[p].device
        recv = torch.stack(
            [sendbufs[d][:, p].to(dev) for d in range(D)], dim=1
        )  # [C, D, s_max]
        buf = torch.zeros((C, g_loc + 1), dtype=recv.dtype, device=dev)
        idx = recv_map[p].reshape(-1).to(torch.int64).clamp(0, g_loc)
        buf[:, idx] = recv.reshape(C, -1)
        res = buf[:, :g_loc]
        out.append(res if stacked else res[0])
    return out


# --------------------------------------------------------------------------
# communication accounting
# --------------------------------------------------------------------------

COMM_CAVEAT = (
    "collectives are accounted per CALL (the PyTorch port executes "
    "eagerly): each row is one (phase, collective, payload shape) with "
    "its number of calls and the payload bytes per device of one call"
)


class CommLog:
    """One run's collective account, held on ``runstate.current().comm``
    (a fresh RunState per run scopes it)."""

    __slots__ = ("log", "phase_stack", "opens")

    def __init__(self) -> None:
        # (phase, op, payload shape) -> [calls, payload bytes per call]
        self.log: Dict[Tuple[str, str, tuple], List[int]] = {}
        self.phase_stack: List[str] = []
        self.opens: Dict[str, int] = {}


def _comm() -> CommLog:
    from ..resilience import runstate

    run = runstate.current()
    if run.comm is None:
        run.comm = CommLog()
    return run.comm


@contextmanager
def comm_phase(name: str):
    """Attribute the collectives called inside to phase `name`."""
    c = _comm()
    c.phase_stack.append(name)
    try:
        yield
    finally:
        c.phase_stack.pop()
        c.opens[name] = c.opens.get(name, 0) + 1


def account_collective(op: str, nbytes: int, shape=None) -> None:
    """Register one collective call of `nbytes` payload per device, keyed
    by (phase, op, payload shape); a no-op outside every comm_phase."""
    c = _comm()
    if not c.phase_stack:
        return
    key = (c.phase_stack[-1], op,
           tuple(int(d) for d in shape) if shape else ())
    entry = c.log.get(key)
    if entry is None:
        entry = c.log[key] = [0, int(nbytes)]
    entry[0] += 1
    from ..telemetry import metrics

    if metrics.enabled():
        metrics.inc(
            "kmp_comm_bytes_total",
            "Collective payload bytes per device, by phase (per-call "
            "account; see COMM_CAVEAT).",
            value=int(nbytes), phase=key[0],
        )
        metrics.inc(
            "kmp_comm_calls_total",
            "Collective calls, by phase (per-call account).",
            phase=key[0],
        )


def reset_comm_log() -> None:
    c = _comm()
    c.log.clear()
    c.opens.clear()


def phase_opens() -> Dict[str, int]:
    return dict(_comm().opens)


def comm_records() -> List[dict]:
    return [
        {
            "phase": phase,
            "op": op,
            "shape": list(shape),
            "calls": calls,
            "payload_bytes_per_device": nbytes,
        }
        for (phase, op, shape), (calls, nbytes)
        in sorted(_comm().log.items())
    ]


def comm_phase_totals() -> Dict[str, Dict[str, int]]:
    """Per-phase rollup: {phase: {bytes_total, calls}} (bytes over every
    call)."""
    totals: Dict[str, Dict[str, int]] = {}
    for (phase, _op, _shape), (calls, nbytes) in sorted(_comm().log.items()):
        t = totals.setdefault(phase, {"bytes_total": 0, "calls": 0})
        t["bytes_total"] += int(nbytes) * int(calls)
        t["calls"] += int(calls)
    return totals


def comm_table() -> str:
    """The per-phase collective account as text."""
    c = _comm()
    if not c.log:
        return "(comm accounting: no collectives called)"
    lines = [
        f"(caveat: {COMM_CAVEAT})",
        "phase | collective | payload shape | calls | "
        "payload bytes/device per call",
    ]
    for (phase, op, shape), (calls, nbytes) in sorted(c.log.items()):
        shp = "x".join(str(d) for d in shape) if shape else "-"
        lines.append(f"{phase} | {op} | {shp} | {calls} | {nbytes}")
    return "\n".join(lines)
