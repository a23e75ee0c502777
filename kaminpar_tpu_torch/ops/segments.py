"""Segmented sort/reduce primitives (counterpart of kaminpar_tpu/ops/segments.py).

Every function computes exactly what its JAX namesake computes, in int32
arithmetic that wraps like XLA's, so both packages agree bitwise.  The
translation rules used throughout:

  * `lax.sort` is stable and multi-key.  Two int32 keys are packed into
    one int64 key ((primary << 32) + secondary + 2^31 preserves the
    lexicographic order of any int32 pair) and sorted with
    `torch.sort(stable=True)`; a third key is a stable sort by it first.
  * `hash_u32` needs wrapping uint32 products: they are computed in int64
    on 16-bit halves of the constant, so no intermediate overflows.
  * sums and cumulative sums pass `dtype=torch.int32` where JAX stays in
    int32; segment ops are `index_add_` / `scatter_reduce_` on buffers
    filled with the JAX identity (0, INT32_MIN, INT32_MAX).
  * where JAX relied on clamped gathers or dropped scatters, indices are
    clipped or masked first.

Salts are host ints (the device loops are host loops in this package).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dtypes import ACC_DTYPE, INT32_MAX, INT32_MIN
from .gather import dense_block_ratings, gather_i32  # noqa: F401  (K2 re-export)

# the JAX package splits multi-round launches above this many edge slots;
# Jet keeps its chunk bookkeeping so both packages count iterations alike
MAX_FUSED_EDGE_SLOTS = 1 << 26

_U32 = 0xFFFFFFFF
_I64 = torch.int64
_I32 = torch.int32


# --------------------------------------------------------------------------
# small helpers
# --------------------------------------------------------------------------


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _shift_right_fill(x: torch.Tensor, fill) -> torch.Tensor:
    """[fill, x[0], ..., x[-2]] — the `prev` column of a sorted array."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=_I32)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _csum0(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-prefix view: [0, cumsum(x)...] in int32."""
    c = _cumsum32(x)
    return torch.cat([c.new_zeros(1), c])


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros(num, dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg.to(_I64), data)


def segment_max(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), INT32_MIN, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg.to(_I64), data, "amax", include_self=True)


def segment_min(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), INT32_MAX, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg.to(_I64), data, "amin", include_self=True)


def pack2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """int64 key ordered like the int32 pair (primary, secondary)."""
    return (primary.to(_I64) << 32) + (secondary.to(_I64) + 2**31)


def float_sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key ordered like float32 `x` under lax.sort (-0 == +0)."""
    bits = (x.to(torch.float32) + 0.0).view(_I32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def lex_order(*keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order by 1-3 int32-valued keys (lax.sort's
    `num_keys` semantics)."""
    if len(keys) == 1:
        return stable_order(keys[0])
    if len(keys) == 2:
        return stable_order(pack2(*keys))
    first = stable_order(keys[2])
    second = stable_order(pack2(keys[0][first], keys[1][first]))
    return first[second]


def scatter_set_drop(
    out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """out.at[idx].set(vals, mode="drop") for non-negative idx (in place):
    indices >= len(out) go to a dropped trailing slot."""
    n = out.shape[0]
    buf = torch.cat([out, out.new_zeros(1)])
    buf[idx.to(_I64).clamp(max=n)] = vals.to(out.dtype)
    out.copy_(buf[:n])
    return out


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def pad_k_bucket(k, max_block_weights, min_block_weights=None):
    """Round k up to a power of two with zero-capacity phantom blocks
    (results are identical; kept for parity of every (n, k) shape)."""
    k_pad = max(2, 1 << (int(k) - 1).bit_length())
    max_block_weights = max_block_weights.to(ACC_DTYPE)
    if min_block_weights is not None:
        min_block_weights = min_block_weights.to(ACC_DTYPE)
    if k_pad != k:
        pad = max_block_weights.new_zeros(k_pad - int(k))
        max_block_weights = torch.cat([max_block_weights, pad])
        if min_block_weights is not None:
            min_block_weights = torch.cat([min_block_weights, pad])
    return k_pad, max_block_weights, min_block_weights


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32 in int64 without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_u32(x: torch.Tensor, salt) -> torch.Tensor:
    """murmur3-style finalizer; returns non-negative int32 (bit-exact with
    the JAX package's uint32 version for any int32 input and salt)."""
    h = x.to(_I64) & _U32
    h = (_mul_u32(h, 0x9E3779B1) + (int(salt) & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 1).to(_I32)


def hash_tie16(x: torch.Tensor, salt) -> torch.Tensor:
    """Top 16 bits of hash_u32 as non-negative int16 (tie-break operand)."""
    return (hash_u32(x, salt) >> 16).to(torch.int16)


def sort_by_two_keys(
    primary: torch.Tensor, secondary: torch.Tensor, *values: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Stable lexicographic sort by (primary, secondary), carrying values."""
    order = lex_order(primary, secondary)
    return tuple(t[order] for t in (primary, secondary) + values)


def aggregate_by_key(
    seg: torch.Tensor, key: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group entries by (seg, key) and sum weights per group; group g sits
    at slot g, unused slots have seg_g == -1 (see the JAX docstring)."""
    m = seg.shape[0]
    dev = seg.device
    seg_s, key_s, w_s = sort_by_two_keys(seg, key, w.to(ACC_DTYPE))
    is_new = (seg_s != _shift_right_fill(seg_s, -1)) | (
        key_s != _shift_right_fill(key_s, -1)
    )
    cum = _cumsum32(w_s)
    base = _cummax(torch.where(is_new, cum - w_s, 0))
    total = cum - base
    is_last = torch.cat([is_new[1:], is_new.new_ones(1)])
    pos = _arange(m, dev)
    out_slot = _cumsum32(is_last.to(_I32)) - 1
    dest = torch.where(is_last, out_slot, m)
    src_pos = scatter_set_drop(torch.full((m,), m, dtype=_I32, device=dev),
                               dest, pos)
    in_groups = src_pos < m
    sp = src_pos.clamp(0, m - 1)
    seg_g = torch.where(in_groups, seg_s[sp], -1)
    key_g = torch.where(in_groups, key_s[sp], -1)
    w_g = torch.where(in_groups, total[sp], 0)
    return seg_g, key_g, w_g


def argmax_per_segment(
    seg: torch.Tensor,
    key: torch.Tensor,
    score: torch.Tensor,
    num_segments: int,
    tie_salt,
    feasible: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per segment, the key with max score among feasible entries, ties by
    max hash_u32(key, tie_salt), then max key; -1 / INT32_MIN if none."""
    ok = seg >= 0
    if feasible is not None:
        ok = ok & feasible
    seg_c = torch.where(ok, seg, num_segments)
    masked = torch.where(ok, score, INT32_MIN)
    best = segment_max(masked, seg_c, num_segments + 1)[:num_segments]
    has = best > INT32_MIN
    seg_cc = seg_c.clamp(0, num_segments - 1)
    is_best = ok & (score == best[seg_cc]) & (seg_c < num_segments)
    tb = hash_u32(key, tie_salt)
    best_tb = segment_max(
        torch.where(is_best, tb, INT32_MIN), seg_c, num_segments + 1
    )[:num_segments]
    winner = is_best & (tb == best_tb[seg_cc])
    best_key = segment_max(
        torch.where(winner, key, INT32_MIN), seg_c, num_segments + 1
    )[:num_segments]
    best_key = torch.where(has, best_key, -1)
    best_score = torch.where(has, best, INT32_MIN)
    return best_key, best_score


def accept_prefix_by_capacity(
    target: torch.Tensor,
    priority: torch.Tensor,
    weight: torch.Tensor,
    capacity: torch.Tensor,
    reach: bool = False,
) -> torch.Tensor:
    """Capacity-respecting parallel commit: entries ordered by (target,
    priority) are accepted while their per-target cumulative weight fits
    `capacity[target]` (with `reach`, the last accepted entry may cross
    it).  A float32 priority sorts like lax.sort orders float32."""
    nb = capacity.shape[0]
    m = target.shape[0]
    dev = target.device
    t = torch.where(target >= 0, target, nb).to(_I32)
    pkey = (
        float_sort_key(priority) if priority.is_floating_point()
        else priority
    )
    order = lex_order(t, pkey)
    t_s = t[order]
    w_s = weight[order].to(ACC_DTYPE)
    c = _cumsum32(w_s)
    is_first = t_s != _shift_right_fill(t_s, -1)
    first_pos = _cummax(torch.where(is_first, _arange(m, dev), 0))
    cum_in_seg = c - (c - w_s)[first_pos]
    cap_here = torch.where(
        t_s < nb, capacity[t_s.clamp(0, nb - 1)].to(ACC_DTYPE), 0
    )
    if reach:
        accepted_sorted = (t_s < nb) & (cum_in_seg - w_s < cap_here)
    else:
        accepted_sorted = (t_s < nb) & (cum_in_seg <= cap_here)
    accept = torch.zeros(m, dtype=torch.bool, device=dev)
    accept[order] = accepted_sorted
    return accept


def move_weight_delta(
    labels: torch.Tensor,
    target: torch.Tensor,
    accept: torch.Tensor,
    node_w: torch.Tensor,
    num_clusters: int,
) -> torch.Tensor:
    """Per-cluster weight delta of a bulk move."""
    moved_w = torch.where(accept, node_w, 0).to(ACC_DTYPE)
    out_w = segment_sum(moved_w, labels.clamp(0, num_clusters - 1),
                        num_clusters)
    in_w = segment_sum(moved_w, target.clamp(0, num_clusters - 1),
                       num_clusters)
    return in_w - out_w


def apply_move_weight_delta(
    cluster_weights: torch.Tensor,
    labels: torch.Tensor,
    target: torch.Tensor,
    accept: torch.Tensor,
    node_w: torch.Tensor,
) -> torch.Tensor:
    """Cluster weights after a bulk move."""
    delta = move_weight_delta(
        labels, target, accept, node_w, cluster_weights.shape[0]
    )
    return (cluster_weights + delta).to(cluster_weights.dtype)


def connection_to_label(
    seg_g: torch.Tensor,
    key_g: torch.Tensor,
    w_g: torch.Tensor,
    labels: torch.Tensor,
    n_pad: int,
) -> torch.Tensor:
    """Per-node connection weight to its own current label (0 if none)."""
    cur_of_group = labels[seg_g.clamp(0, n_pad - 1)]
    match = (seg_g >= 0) & (key_g == cur_of_group)
    seg_c = torch.where(match, seg_g, n_pad)
    w_cur = segment_max(torch.where(match, w_g, 0), seg_c, n_pad + 1)[:n_pad]
    return w_cur.clamp(min=0)


def combine_labels(l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Intersect two clusterings (overlay_cluster_coarsener.cc): nodes
    share an output label iff they share a label in both inputs.  The
    output label of a group is its minimum node id, as lp_cluster's."""
    n = l1.shape[0]
    order = lex_order(l1, l2)  # stable: node order within a (l1, l2) key
    a, b = l1[order], l2[order]
    is_new = (a != _shift_right_fill(a, -1)) | (b != _shift_right_fill(b, -1))
    gid = _cumsum32(is_new.to(_I32)) - 1
    leader = segment_min(order.to(_I32), gid, n)
    out = torch.zeros(n, dtype=_I32, device=l1.device)
    out[order] = leader[gid.to(_I64)]
    return out


def compact_unique(
    labels: torch.Tensor, n_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remap label values in [0, n_pad) to dense ids; (dense, count)."""
    used = torch.zeros(n_pad, dtype=_I32, device=labels.device)
    keep = (labels >= 0) & (labels < n_pad)
    used[labels[keep].to(_I64)] = 1
    rank = _cumsum32(used) - used
    dense = rank[labels.clamp(0, n_pad - 1)]
    return dense, used.sum(dtype=_I32)


# --------------------------------------------------------------------------
# sort-free rating engines
# --------------------------------------------------------------------------


def hashed_rating_table(
    src: torch.Tensor,
    neighbor_label: torch.Tensor,
    edge_w: torch.Tensor,
    n_pad: int,
    num_slots: int,
    salt,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node hashed rating rows (slot_label, slot_w), [n_pad, slots]:
    each slot's winning label and its exact connection weight."""
    if n_pad * num_slots >= 2**31:
        raise ValueError("n_pad * num_slots must fit in int32")
    slot = hash_u32(neighbor_label, salt) % num_slots
    flat = src.to(_I32) * num_slots + slot
    total = n_pad * num_slots
    key = hash_u32(neighbor_label, int(salt) ^ 0x3779B97F)
    kmax = segment_max(key, flat, total)
    is_kwin = key == kmax[flat.to(_I64)]
    lwin = segment_max(torch.where(is_kwin, neighbor_label, -1), flat, total)
    is_win = is_kwin & (neighbor_label == lwin[flat.to(_I64)])
    w = segment_sum(torch.where(is_win, edge_w, 0).to(ACC_DTYPE), flat, total)
    slot_label = torch.where(kmax >= 0, lwin, -1)
    return slot_label.view(n_pad, num_slots), w.view(n_pad, num_slots)


def _lexmax_rows(feas, score, tb, cand_label):
    """Row-wise max by (score, tb, label) over feasible entries — the
    three-stage reduction every rating table ends with."""
    best_w = score.max(dim=1).values
    has = best_w > INT32_MIN
    is_best = feas & (score == best_w[:, None])
    best_tb = torch.where(is_best, tb, -1).max(dim=1).values
    winner = is_best & (tb == best_tb[:, None])
    best = torch.where(winner, cand_label, -1).max(dim=1).values
    return torch.where(has, best, -1), torch.where(has, best_w, INT32_MIN)


def best_from_rating_table(
    slot_label: torch.Tensor,
    slot_w: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    salt,
    communities: torch.Tensor | None = None,
    require_fit: bool = True,
    label_range=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node best move target from a hashed rating table (the hash
    engine's selection; same contract as argmax_per_segment)."""
    C = cluster_weights.shape[0]
    lab_c = slot_label.clamp(0, C - 1)
    feas = (slot_label >= 0) & (slot_label != labels[:, None])
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
        feas = feas & (communities[lab_c] == communities[:, None])
    score = torch.where(feas, slot_w, INT32_MIN)
    tb = hash_u32(slot_label, salt)
    return _lexmax_rows(feas, score, tb, slot_label)


def connection_to_own_label(
    src: torch.Tensor,
    neighbor_label: torch.Tensor,
    edge_w: torch.Tensor,
    labels: torch.Tensor,
    n_pad: int,
) -> torch.Tensor:
    """Exact per-node connection weight to the node's own label."""
    match = neighbor_label == labels[src.clamp(0, n_pad - 1)]
    return segment_sum(
        torch.where(match, edge_w, 0).to(ACC_DTYPE), src, n_pad
    )


def best_from_dense(
    conn: torch.Tensor,
    labels: torch.Tensor,
    cluster_weights: torch.Tensor,
    node_w: torch.Tensor,
    cap: torch.Tensor,
    salt,
    communities: torch.Tensor | None = None,
    require_fit: bool = True,
    allowed: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-node (best_block, best_w, w_own) from a dense rating table,
    excluding the node's own block, with hashed tie-breaking."""
    n_pad, k = conn.shape
    lab_col = labels.clamp(0, k - 1)
    w_own = conn.gather(1, lab_col[:, None].to(_I64))[:, 0]
    cols = _arange(k, conn.device)
    feas = cols[None, :] != lab_col[:, None]
    if allowed is not None:
        feas = feas & allowed[None, :]
    if require_fit:
        cap_b = cap.expand(k).to(ACC_DTYPE)
        feas = feas & (
            cluster_weights[None, :].to(ACC_DTYPE)
            + node_w[:, None].to(ACC_DTYPE)
            <= cap_b[None, :]
        )
    if communities is not None:
        feas = feas & (communities[:k][None, :] == communities[:, None])
    score = torch.where(feas, conn, INT32_MIN)
    tb = hash_u32(cols, salt)[None, :]
    best, best_w = _lexmax_rows(feas, score, tb, cols[None, :])
    return best, best_w, w_own


def rating_top3_by_sort(
    graph, neighbor_label: torch.Tensor, salt, k_best: int = 3
) -> Tuple[torch.Tensor, ...]:
    """Top-k_best rated clusters per node via two edge-wide sorts, read at
    CSR row ends (the "sort2" engine over the full edge list)."""
    src_s, nb_s, w_s = sort_by_two_keys(
        graph.src, neighbor_label, graph.edge_w.to(ACC_DTYPE)
    )
    return _topk_from_sorted(
        src_s, nb_s, w_s, graph.row_ptr[1:], graph.degrees, salt, k_best
    )


def _topk_from_sorted(o_s, nb_s, w_s, end, deg, salt, k_best):
    new_grp = (o_s != _shift_right_fill(o_s, -1)) | (
        nb_s != _shift_right_fill(nb_s, -1)
    )
    cum = _cumsum32(w_s)
    base = _cummax(torch.where(new_grp, cum - w_s, 0))
    total = cum - base
    is_last = torch.cat([new_grp[1:], new_grp.new_ones(1)])
    tb = hash_tie16(nb_s, salt)
    prio = torch.where(is_last, total, -1)
    order = lex_order(o_s, prio, tb)
    prio2 = prio[order]
    lab2 = nb_s[order]
    D = prio2.shape[0]
    out = []
    for j in range(k_best):
        posj = (end - 1 - j).clamp(0, D - 1)
        validj = (deg > j) & (prio2[posj] >= 0)
        out.append(torch.where(validj, lab2[posj], -1))
        out.append(torch.where(validj, prio2[posj], INT32_MIN))
    return tuple(out)


def expand_active_rows(
    row_ptr: torch.Tensor,
    degrees: torch.Tensor,
    active: torch.Tensor,
    num_slots: int,
):
    """Compact the CSR rows of active nodes into a `num_slots` buffer.

    Returns (owner_c, owner_key, edge_id, valid, start, end) as in the JAX
    package: owning node per slot (clipped), owner or n_pad for pad
    slots, edge index per slot (clip before use), the valid mask, and
    each active node's [start, end) span in the buffer."""
    n_pad = degrees.shape[0]
    dev = degrees.device
    act = active & (degrees > 0)
    act_deg = torch.where(act, degrees, 0).to(_I32)
    end = _cumsum32(act_deg)
    start = end - act_deg
    node_ids = _arange(n_pad, dev)
    do = act & (start < num_slots)
    pos = torch.where(do, start, num_slots)
    owner0 = torch.full((num_slots + 1,), -1, dtype=_I32, device=dev)
    owner0.scatter_reduce_(
        0, pos.to(_I64), torch.where(do, node_ids, -1), "amax",
        include_self=True,
    )
    owner = _cummax(owner0[:num_slots])
    slot = _arange(num_slots, dev)
    owner_c = owner.clamp(0, n_pad - 1)
    diff = row_ptr[:-1].to(_I32) - start
    edge_id = diff[owner_c] + slot
    valid = (owner >= 0) & (slot < end[n_pad - 1])
    owner_key = torch.where(valid, owner_c, n_pad)
    return owner_c, owner_key, edge_id, valid, start, end


def prune_candidates_to_budget(
    candidate: torch.Tensor,
    gain: torch.Tensor,
    degrees: torch.Tensor,
    salt,
    budget: int,
) -> torch.Tensor:
    """Restrict `candidate` to the best-(gain, hashed tie) subset whose
    total degree fits `budget` edge slots (Jet's candidate pruning)."""
    n_pad = candidate.shape[0]
    node_ids = _arange(n_pad, candidate.device)
    key = torch.where(
        candidate, gain.clamp(min=INT32_MIN + 2), INT32_MIN + 1
    )
    tb = hash_u32(node_ids, salt)
    order = lex_order(-key, -tb)
    deg = torch.where(candidate, degrees, 0).to(_I32)
    keep_s = _cumsum32(deg[order]) <= budget
    keep = torch.zeros(n_pad, dtype=torch.bool, device=candidate.device)
    keep[order] = keep_s
    return candidate & keep


def rating_topk_rows(
    owner_key: torch.Tensor,
    nb: torch.Tensor,
    w: torch.Tensor,
    end: torch.Tensor,
    deg: torch.Tensor,
    salt,
    k_best: int,
) -> Tuple[torch.Tensor, ...]:
    """Top-k_best rated clusters per row from row-grouped (owner, label,
    weight) slots; returns (lab1, w1, ..., lab_k, w_k), each [n_pad],
    absent entries (-1, INT32_MIN)."""
    o_s, nb_s, w_s = sort_by_two_keys(owner_key, nb, w.to(ACC_DTYPE))
    return _topk_from_sorted(o_s, nb_s, w_s, end, deg, salt, k_best)


def connection_to_own_rows(
    nb: torch.Tensor,
    w: torch.Tensor,
    own_of_slot: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
) -> torch.Tensor:
    """Exact per-row connection to the row node's own label, via a masked
    cumsum over row spans."""
    D = nb.shape[0]
    csum0 = _csum0(torch.where(nb == own_of_slot, w, 0).to(ACC_DTYPE))
    return csum0[end.clamp(0, D)] - csum0[start.clamp(0, D)]


def packed_afterburner_gain(
    src, dst, edge_w, row_ptr, part, next_part, gain, candidate, k: int
) -> torch.Tensor:
    """Afterburner-adjusted gain per node over the CSR edge list (a row
    buffer with owner = src and spans [row_ptr[i], row_ptr[i+1]))."""
    adj, _, _ = packed_afterburner_gain_rows(
        src, dst, edge_w, row_ptr[:-1], row_ptr[1:],
        part, next_part, gain, candidate, k,
    )
    return adj


def packed_afterburner_gain_rows(
    owner, dst, edge_w, start, end, part, next_part, gain, candidate,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """packed_afterburner_gain over a row buffer.  Returns (adj_gain[n_pad],
    from_u[slots], to_u[slots]).  The packed (one gather per endpoint)
    layout runs while every candidate |gain| fits its bit field; a host
    check of that guard picks the exact layout otherwise, as the JAX
    package's lax.cond does."""
    label_bits = max((k - 1).bit_length(), 1)
    gain_bits = 31 - 2 * label_bits

    def row_sums(to_u, from_u, block_v, u_is_cand):
        contrib = torch.where(
            to_u == block_v, edge_w,
            torch.where(from_u == block_v, -edge_w, 0),
        )
        D = contrib.shape[0]
        csum0 = _csum0(torch.where(u_is_cand, contrib, 0).to(ACC_DTYPE))
        return csum0[end.clamp(0, D)] - csum0[start.clamp(0, D)]

    if gain_bits >= 15:
        half = 1 << (gain_bits - 1)
        max_abs_gain = torch.where(
            candidate, gain.clamp(-(2**30), 2**30).abs(), 0
        ).max()
        if int(max_abs_gain) < half:
            gain_clip = gain.clamp(1 - half, half - 1) + half
            gain_field = torch.where(candidate, gain_clip, 0).to(_I32)
            meta = (
                (gain_field << (2 * label_bits))
                | (next_part << label_bits)
                | part
            ).to(_I32)
            mu = meta[owner]
            mv = gather_i32(meta, dst)
            lab_mask = (1 << label_bits) - 1
            gain_u = mu >> (2 * label_bits)
            gain_v = mv >> (2 * label_bits)
            v_before_u = (gain_v > 0) & (
                (gain_v > gain_u) | ((gain_v == gain_u) & (dst < owner))
            )
            block_v = torch.where(
                v_before_u, (mv >> label_bits) & lab_mask, mv & lab_mask
            )
            to_u = (mu >> label_bits) & lab_mask
            from_u = mu & lab_mask
            return row_sums(to_u, from_u, block_v, gain_u > 0), from_u, to_u
    gain_full = torch.where(candidate, gain, INT32_MIN).to(_I32)
    gain_u = gain_full[owner]
    gain_v = gather_i32(gain_full, dst)
    v_before_u = (gain_v > INT32_MIN) & (
        (gain_v > gain_u) | ((gain_v == gain_u) & (dst < owner))
    )
    block_v = torch.where(
        v_before_u, gather_i32(next_part, dst), gather_i32(part, dst)
    )
    from_u = part[owner]
    to_u = next_part[owner]
    return (
        row_sums(to_u, from_u, block_v, gain_u > INT32_MIN), from_u, to_u
    )


def neighbor_any_true(
    flag: torch.Tensor, dst: torch.Tensor, row_ptr: torch.Tensor
) -> torch.Tensor:
    """Per-node "any neighbour has `flag`": one edge gather plus a cumsum
    and CSR row-boundary diff (edge list in CSR order)."""
    f = gather_i32(flag.to(_I32), dst)
    csum0 = _csum0(f)
    rp = row_ptr.clamp(0, f.shape[0])
    return (csum0[rp[1:]] - csum0[rp[:-1]]) > 0


def afterburner_filter(
    src, dst, edge_w, labels_of_src, labels_of_dst, gain_by_node,
    target_by_node, seg, num_segments: int, src_order=None, dst_order=None,
) -> torch.Tensor:
    """Jet's afterburner as a reusable filter: each candidate's gain
    re-evaluated assuming every neighbour ordered strictly before it (by
    gain, then smaller id) already sits at its target."""
    if src_order is None:
        src_order = src
    if dst_order is None:
        dst_order = dst
    gain_u = gain_by_node[src]
    gain_v = gain_by_node[dst]
    v_before_u = (gain_v > INT32_MIN) & (
        (gain_v > gain_u) | ((gain_v == gain_u) & (dst_order < src_order))
    )
    block_v = torch.where(v_before_u, target_by_node[dst], labels_of_dst)
    to_u = target_by_node[src]
    contrib = torch.where(
        to_u == block_v, edge_w,
        torch.where(labels_of_src == block_v, -edge_w, 0),
    )
    return segment_sum(
        torch.where(gain_u > INT32_MIN, contrib, 0).to(ACC_DTYPE),
        seg.clamp(0, num_segments - 1),
        num_segments,
    )
