"""Rating engines (counterpart of kaminpar_tpu/ops/rating.py).

`select_engine` is the JAX package's density-adaptive rule, copied;
`scatter_slot_ratings` builds the two-pass hashed slot table in plain
torch; `best_from_slots` is kernel K3, the per-row rate + arg-max over
that table (the port of the TPU kernel `best_from_slots_pallas`, with the
feasibility mask of the masked `best_from_slots` folded in).
`scatter_best_from_slots` is the fused K3 the scatter engine runs: one
kernel builds each row's slot table in shared memory from the row's span
and rates it, so the table never reaches device memory; it takes the
v-cycle's `communities=` restriction on the card as well.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _native
from ..dtypes import ACC_DTYPE, INT32_MIN
from .gather import MAX_RATING_SLOTS, _require_i32_on, _stream, span_slots
from .segments import (  # noqa: F401  (re-exported rating surface)
    _cumsum32,
    _lexmax_rows,
    best_from_dense,
    dense_block_ratings,
    hash_u32,
    segment_max,
    segment_sum,
)

DEFAULT_NUM_SLOTS = 32
SCATTER_FALLBACK_FRAC = 0.5


def select_engine(
    rating: str,
    num_clusters: int,
    n: int,
    m_slots: int,
    num_slots: int = DEFAULT_NUM_SLOTS,
    avg_degree: Optional[float] = None,
    degree_skew: Optional[float] = None,
    row_spans: bool = True,
) -> Tuple[str, str]:
    """Pick a rating engine for one level; returns (engine, reason).

    In order: a forced engine is respected; a label space <= 256 takes
    the dense table; a level whose density fits the slot budget with
    moderate degree skew takes the scatter slot table; otherwise sort2
    (or sort without row spans).  See the JAX package for the measured
    rationale of each threshold."""
    if rating != "auto":
        return rating, "forced"
    if num_clusters <= 256:
        return "dense", f"labels={num_clusters}<=256"
    if avg_degree is None:
        avg_degree = m_slots / max(n, 1)
    if degree_skew is None:
        degree_skew = 1.0
    scatter_reject = None
    if avg_degree > num_slots:
        scatter_reject = f"avg_degree={avg_degree:.1f}>slots={num_slots}"
    elif not (8 <= degree_skew <= 4096):
        scatter_reject = f"degree_skew={degree_skew:.1f} outside [8, 4096]"
    elif n * num_slots > (1 << 27):
        scatter_reject = f"n*slots={n * num_slots} past the int32 budget"
    elif 2 * n * num_slots > 12 * m_slots:
        scatter_reject = "slot table past 6x the edge width"
    if scatter_reject is None:
        return "scatter", f"avg_degree={avg_degree:.1f}<=slots={num_slots}"
    if row_spans:
        return "sort2", scatter_reject
    return "sort", f"{scatter_reject}; no row spans (sharded COO)"


def _label_bits(n_pad: int, num_slots: int,
                label_space: Optional[int] = None) -> int:
    """Bits of a slot table's winner key that hold the label (labels are
    rows unless `label_space` says otherwise); raises where the table or
    the key does not fit int32."""
    if n_pad * num_slots >= 2**30:
        raise ValueError("n_pad * num_slots must stay well inside int32")
    if label_space is None:
        label_space = n_pad
    label_bits = max(int(label_space - 1).bit_length(), 1)
    if 31 - label_bits < 4:
        raise ValueError(
            f"label_space={n_pad} leaves {31 - label_bits} winner-key "
            "bits; use the sort engine at this scale"
        )
    return label_bits


def scatter_slot_ratings(
    owner: torch.Tensor,
    neighbor_label: torch.Tensor,
    edge_w: torch.Tensor,
    n_pad: int,
    num_slots: int,
    salt,
    valid: torch.Tensor | None = None,
    spans: Tuple[torch.Tensor, torch.Tensor] | None = None,
    label_space: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-where-rated hashed rating rows via scatter-adds only.

    Returns (slot_label i32[n_pad, 2*num_slots], slot_w ACC[n_pad,
    2*num_slots], fully_rated bool[n_pad]).  A slot whose edges all carry
    one label holds that label's exact connection weight; contested
    slots keep a hashed winner and the losers retry under a second salt;
    labels still contested after both passes leave their row not fully
    rated.  `label_space` bounds the label domain where it differs from
    the rows (a dist shard's n_loc rows rate global cluster ids)."""
    if label_space is None:
        label_space = n_pad
    label_bits = _label_bits(n_pad, num_slots, label_space)
    key_bits = 31 - label_bits
    total = n_pad * num_slots
    lab_mask = (1 << label_bits) - 1
    nb_c = neighbor_label.clamp(0, label_space - 1)
    ok = neighbor_label >= 0
    if valid is not None:
        ok = ok & valid

    def one_pass(pass_salt, active_edge):
        slot = hash_u32(nb_c, pass_salt) % num_slots
        flat = torch.where(
            active_edge, owner.to(torch.int32) * num_slots + slot, total
        )
        key = (
            (hash_u32(nb_c, int(pass_salt) ^ 0x3779B97F)
             & ((1 << key_bits) - 1)) << label_bits
        ) | nb_c
        win = segment_max(
            torch.where(active_edge, key, -1), flat, total + 1
        )[:total]
        win_label = torch.where(win >= 0, win & lab_mask, -1)
        flat_c = flat.clamp(0, total - 1)
        is_win = active_edge & (win_label[flat_c] == nb_c)
        w = segment_sum(
            torch.where(is_win, edge_w, 0).to(ACC_DTYPE), flat, total + 1
        )[:total]
        edge_lost = active_edge & ~is_win
        return (
            win_label.view(n_pad, num_slots),
            w.view(n_pad, num_slots),
            edge_lost,
        )

    lab1, w1, lost1 = one_pass(salt, ok)
    # jnp.int32(salt) ^ 0x5851F42D: the low 32 bits are all hash_u32 reads
    lab2, w2, lost2 = one_pass(int(salt) ^ 0x5851F42D, lost1)
    if spans is not None:
        start, end = spans
        csum = _cumsum32(lost2.to(ACC_DTYPE))
        csum0 = torch.cat([csum.new_zeros(1), csum])
        D = lost2.shape[0]
        fully_rated = (csum0[end.clamp(0, D)] - csum0[start.clamp(0, D)]) == 0
    else:
        owner_c = owner.clamp(0, n_pad - 1)
        unrated = segment_max(
            lost2.to(torch.int32),
            torch.where(lost2, owner_c, n_pad - 1),
            n_pad,
        )
        fully_rated = unrated.clamp(min=0) == 0
    return (
        torch.cat([lab1, lab2], dim=1),
        torch.cat([w1, w2], dim=1),
        fully_rated,
    )


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------


def best_from_slots_twin(
    slot_label: torch.Tensor,
    slot_w: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    tie_salt,
    communities: torch.Tensor | None = None,
    require_fit: bool = True,
    label_range=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of K3 (rating.best_from_slots of the JAX
    package, communities and label_range included)."""
    n_pad = slot_label.shape[0]
    C = cluster_weights.shape[0]
    lab_c = slot_label.clamp(0, C - 1)
    own = labels[:, None]
    w_own = torch.where(slot_label == own, slot_w, 0).max(dim=1).values
    feas = (slot_label >= 0) & (slot_label != own)
    if label_range is not None:
        lo, hi = label_range
        feas = feas & (slot_label >= lo) & (slot_label < hi)
    if require_fit:
        cap_b = cap.expand(C)
        feas = feas & (
            cluster_weights[lab_c].to(ACC_DTYPE)
            + node_w[:, None].to(ACC_DTYPE)
            <= cap_b[lab_c]
        )
    if communities is not None:
        lab_n = slot_label.clamp(0, n_pad - 1)
        feas = feas & (communities[lab_n] == communities[:, None])
    score = torch.where(feas, slot_w, INT32_MIN)
    tb = hash_u32(slot_label, tie_salt)
    best, best_w = _lexmax_rows(feas, score, tb, slot_label)
    return best, best_w, w_own


def best_from_slots(
    slot_label: torch.Tensor,
    slot_w: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    tie_salt,
    communities: torch.Tensor | None = None,
    require_fit: bool = True,
    label_range=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-node (best_label, best_w, w_own) from scatter slot tables: max
    weight, then max hash_u32(label, tie_salt), then max label among the
    feasible non-own slots; -1 / INT32_MIN when none.  `communities`
    (i32[rows], read at clip(label, 0, rows - 1)) and `label_range`
    (lo, hi: only labels in [lo, hi) are feasible) mask the candidates
    after w_own is taken."""
    if slot_label.device.type == "cpu":
        return best_from_slots_twin(
            slot_label, slot_w, labels, cluster_weights, node_w, cap,
            tie_salt, communities=communities, require_fit=require_fit,
            label_range=label_range,
        )
    n_pad, S = slot_label.shape
    C = cluster_weights.shape[0]
    cap = cap.expand(C).to(torch.int32)
    slot_label, slot_w, labels, cluster_weights, node_w, cap = (
        t.contiguous() for t in
        (slot_label, slot_w, labels, cluster_weights, node_w, cap)
    )
    _require_i32_on(slot_label.device, slot_label, slot_w, labels,
                    cluster_weights, node_w, cap)
    if slot_w.shape != (n_pad, S) or labels.shape != (n_pad,) or (
        node_w.shape != (n_pad,)
    ):
        raise ValueError("best_from_slots: inconsistent shapes")
    comm_ptr = None
    if communities is not None:
        communities = communities.contiguous()
        _require_i32_on(slot_label.device, communities)
        if communities.shape != (n_pad,):
            raise ValueError("best_from_slots: communities must have one "
                             "entry per row")
        comm_ptr = communities.data_ptr()
    lo, hi = (0, 0) if label_range is None else (
        int(label_range[0]), int(label_range[1]))
    best = torch.empty(n_pad, dtype=torch.int32, device=slot_label.device)
    best_w = torch.empty_like(best)
    w_own = torch.empty_like(best)
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    fn = _native.bind(
        "best_from_slots.cu", "kp_best_from_slots",
        (vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, c_int,
         c_int, ctypes.c_uint, c_int, vp, c_int, c_int, c_int, vp),
    )
    with _native.timed("best_from_slots"):
        code = fn(
            slot_label.data_ptr(), slot_w.data_ptr(), labels.data_ptr(),
            cluster_weights.data_ptr(), node_w.data_ptr(), cap.data_ptr(),
            best.data_ptr(), best_w.data_ptr(), w_own.data_ptr(),
            n_pad, S, C, int(tie_salt) & 0xFFFFFFFF, int(bool(require_fit)),
            comm_ptr, int(label_range is not None), lo, hi, _stream(),
        )
    _native.check(code, "best_from_slots")
    best_from_slots.launches += 1
    return best, best_w, w_own


best_from_slots.launches = 0


# --------------------------------------------------------------------------
# fused K3
# --------------------------------------------------------------------------

# the largest num_slots the fused kernel takes (its tables are 4 *
# num_slots int32 per row in shared memory)
MAX_FUSED_SLOTS = 256


def scatter_best_from_slots_twin(
    start: torch.Tensor,
    end: torch.Tensor,
    dst_b: torch.Tensor,
    w_b: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    num_slots: int,
    salt,
    require_fit: bool = True,
    communities: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the fused K3: scatter_slot_ratings over the
    slots of each row's clipped span, then best_from_slots_twin (the JAX
    package's lp.py composition)."""
    n_pad = labels.shape[0]
    rows, slot, length = span_slots(start, end, dst_b.shape[0], n_pad)
    nb = labels[dst_b[slot].clamp(0, n_pad - 1)]
    first = torch.cumsum(length, 0) - length
    slot_label, slot_w, fully_rated = scatter_slot_ratings(
        rows, nb, w_b[slot], n_pad, num_slots, salt,
        spans=(first, first + length),
    )
    best, best_w, w_own = best_from_slots_twin(
        slot_label, slot_w, labels, cluster_weights, node_w, cap, salt,
        communities=communities, require_fit=require_fit,
    )
    return best, best_w, w_own, fully_rated


def scatter_best_from_slots(
    start: torch.Tensor,
    end: torch.Tensor,
    dst_b: torch.Tensor,
    w_b: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    num_slots: int,
    salt,
    require_fit: bool = True,
    communities: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row u, the scatter engine's rating of the edges in its span
    [start[u], end[u]) of the buffer (dst_b, w_b), clipped to the buffer:
    (best i32, best_w i32, w_own i32, fully_rated bool), each [n_pad],
    n_pad = len(labels).  Exactly scatter_slot_ratings(...) followed by
    best_from_slots(..., tie salt = `salt`); the neighbour labels
    labels[dst_b] are gathered by the kernel.  `communities` (i32[n_pad],
    the v-cycle's restriction) bars every label l from row u whose
    communities[clamp(l, 0, n_pad - 1)] differs from communities[u]."""
    if dst_b.device.type == "cpu":
        return scatter_best_from_slots_twin(
            start, end, dst_b, w_b, labels, cluster_weights, node_w, cap,
            num_slots, salt, require_fit=require_fit,
            communities=communities,
        )
    if not 1 <= num_slots <= MAX_FUSED_SLOTS:
        raise ValueError(f"scatter_best_from_slots kernel: num_slots="
                         f"{num_slots} outside [1, {MAX_FUSED_SLOTS}]")
    n_pad = labels.shape[0]
    label_bits = _label_bits(n_pad, num_slots)
    C = cluster_weights.shape[0]
    cap = cap.expand(C).to(torch.int32)
    start, end, dst_b, w_b, labels, cluster_weights, node_w, cap = (
        t.contiguous() for t in
        (start, end, dst_b, w_b, labels, cluster_weights, node_w, cap)
    )
    dev = dst_b.device
    _require_i32_on(dev, start, end, dst_b, w_b, labels, cluster_weights,
                    node_w, cap)
    if not (start.shape == end.shape == node_w.shape == (n_pad,)):
        raise ValueError("start, end and node_w must have n_pad entries")
    comm_ptr = None
    if communities is not None:
        communities = communities.contiguous()
        _require_i32_on(dev, communities)
        if communities.shape != (n_pad,):
            raise ValueError("communities must have n_pad entries")
        comm_ptr = communities.data_ptr()
    if dst_b.shape != w_b.shape or dst_b.dim() != 1:
        raise ValueError("dst_b and w_b must be one 1-D shape")
    slots = dst_b.numel()
    if slots > MAX_RATING_SLOTS:
        raise ValueError(f"scatter_best_from_slots: {slots} slots exceed "
                         "the kernel's int32 slot index")
    best = torch.empty(n_pad, dtype=torch.int32, device=dev)
    best_w = torch.empty_like(best)
    w_own = torch.empty_like(best)
    fully_rated = torch.empty(n_pad, dtype=torch.bool, device=dev)
    heavy = torch.empty(n_pad + 1, dtype=torch.int32, device=dev)
    vp, c_int = ctypes.c_void_p, ctypes.c_int
    fn = _native.bind(
        "best_from_slots.cu", "kp_scatter_best_from_slots",
        (vp,) * 14 + (c_int,) * 5 + (ctypes.c_uint, c_int, vp),
    )
    with _native.timed("scatter_best_from_slots"):
        code = fn(
            start.data_ptr(), end.data_ptr(), dst_b.data_ptr(),
            w_b.data_ptr(), labels.data_ptr(), cluster_weights.data_ptr(),
            node_w.data_ptr(), cap.data_ptr(), comm_ptr, best.data_ptr(),
            best_w.data_ptr(), w_own.data_ptr(), fully_rated.data_ptr(),
            heavy.data_ptr(), n_pad, slots, C, num_slots, label_bits,
            int(salt) & 0xFFFFFFFF, int(bool(require_fit)), _stream(),
        )
    _native.check(code, "scatter_best_from_slots")
    scatter_best_from_slots.launches += 1
    return best, best_w, w_own, fully_rated


scatter_best_from_slots.launches = 0
