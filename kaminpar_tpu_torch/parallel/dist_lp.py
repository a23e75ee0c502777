"""Distributed bulk-synchronous label propagation over the shard mesh
(counterpart of kaminpar_tpu/parallel/dist_lp.py).

Labels are owner-sharded: shard d keeps its owned nodes' labels
(labels_l, n_loc) and its ghosts' labels (ghost_lab, g_loc); the local
label table is their concatenation, indexed by dst_local.  A round is the
JAX package's round body split at its collectives:

  1. per shard: rate (K1 gathers the neighbour labels; the engine is the
     JAX package's choice for the shard's shapes) and select movers;
     under refinement, a halo exchange of (gain, target) and the
     afterburner;
  2. the psum'd join demand throttles each shard's capacity share
     (mesh.throttled_local_capacity);
  3. per shard: the capacity-respecting commit, then one halo exchange of
     the new labels (and moved flags) and the psum of weight deltas;
  4. per shard: the active set; the psum'd count of wanting nodes ends
     the loop when it is 0.

The scatter engine's per-shard choice between its slot table and the
sort fallback (a lax.cond on a local predicate in the JAX package) and
the loop's exit count are read back together: one host sync per round
for all shards.  K2 rates the dense engine over each shard's CSR spans
with the ghost-extended label table; the standalone K3 picks the scatter
engine's winner, with ``label_range`` under ``local-lp``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..dtypes import ACC_DTYPE, INT32_MIN
from ..ops.gather import dense_block_ratings, gather_i32
from ..ops.lp import LPConfig
from ..ops.rating import best_from_slots, scatter_slot_ratings, select_engine
from ..ops.segments import (
    accept_prefix_by_capacity,
    afterburner_filter,
    aggregate_by_key,
    argmax_per_segment,
    best_from_dense,
    best_from_rating_table,
    connection_to_label,
    connection_to_own_label,
    hash_u32,
    hashed_rating_table,
    move_weight_delta,
    segment_max,
    segment_sum,
)
from .dist_graph import DistGraph
from .mesh import (
    account_collective,
    all_gather,
    halo_exchange,
    psum,
    throttled_local_capacity,
)

_I32 = torch.int32


def _salt(seed: int, i: int) -> int:
    """(int32(seed) * 131071 + i * 1566083941) & 0x7FFFFFFF, wrapping."""
    return (int(seed) * 131071 + int(i) * 1566083941) & 0x7FFFFFFF


class _ShardState:
    __slots__ = ("sh", "seg", "dstloc_c", "labels", "ghost", "active",
                 "movable", "node_ids", "n_tab")

    def __init__(self, sh, n_loc, g_loc, labels0, movable):
        dev = sh.src.device
        self.sh = sh
        self.seg = sh.src - sh.offset
        self.n_tab = n_loc + g_loc
        self.dstloc_c = sh.dst_local.clamp(0, self.n_tab - 1)
        self.labels = labels0[sh.offset: sh.offset + n_loc].to(dev).clone()
        self.ghost = gather_i32(
            labels0, sh.ghost_gid.to(labels0.device).clamp(
                0, labels0.shape[0] - 1)).to(dev)
        self.active = torch.ones(n_loc, dtype=torch.bool, device=dev)
        self.movable = movable[sh.offset: sh.offset + n_loc].to(dev)
        self.node_ids = sh.offset + torch.arange(n_loc, dtype=_I32,
                                                 device=dev)


def _scatter_prepare(st: _ShardState, cfg: LPConfig, salt: int, C: int):
    """The scatter engine's slot tables and its fallback predicate terms
    (barred rows, active rows) of one shard."""
    n_loc = st.labels.shape[0]
    lab_tab = torch.cat([st.labels, st.ghost])
    nb = gather_i32(lab_tab, st.dstloc_c)
    in_range = (st.seg >= 0) & (st.seg < n_loc)
    slot_label, slot_w, fully = scatter_slot_ratings(
        st.seg.clamp(0, n_loc - 1), nb, st.sh.edge_w, n_loc, cfg.num_slots,
        salt, valid=in_range, label_space=C,
    )
    n_bar = (st.active & ~fully).sum(dtype=_I32)
    n_act = st.active.sum(dtype=_I32)
    return (nb, lab_tab, slot_label, slot_w, fully), torch.stack([n_bar,
                                                                 n_act])


def _use_scatter(n_bar: int, n_act: int, frac: float) -> bool:
    return bool(np.float32(n_bar) <= np.float32(frac) * np.float32(n_act))


def _rate(st: _ShardState, cfg: LPConfig, engine: str, salt: int,
          weights, cap, C: int, prep=None, use_scatter=True):
    """Per-shard rating: (best, best_w, w_cur, barred, neighbour labels)."""
    sh = st.sh
    n_loc = st.labels.shape[0]
    offset = sh.offset
    seg, ew, nw_l, labels_l = st.seg, sh.edge_w, sh.node_w, st.labels
    dev = labels_l.device
    barred = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    if engine == "scatter":
        nb, _, slot_label, slot_w, fully = prep
    else:
        lab_tab = torch.cat([labels_l, st.ghost])
        nb = gather_i32(lab_tab, st.dstloc_c)

    def sort_rate(seg_in):
        seg_g, key_g, w_g = aggregate_by_key(seg_in, nb, ew)
        key_c = key_g.clamp(0, C - 1)
        seg_c = seg_g.clamp(0, n_loc - 1)
        fits = (weights[key_c].to(ACC_DTYPE) + nw_l[seg_c].to(ACC_DTYPE)
                <= cap[key_c])
        feasible = (seg_g >= 0) & (key_g != labels_l[seg_c]) & fits
        if cfg.dist_local_only:
            feasible = feasible & (key_g >= offset) & (
                key_g < offset + n_loc)
        b, bw = argmax_per_segment(seg_g, key_g, w_g, n_loc, tie_salt=salt,
                                   feasible=feasible)
        w_own = connection_to_label(seg_g, key_g, w_g, labels_l, n_loc)
        return b, bw, w_own

    if engine == "scatter":
        if use_scatter:
            label_range = ((offset, offset + n_loc) if cfg.dist_local_only
                           else None)
            best, best_w, w_cur = best_from_slots(
                slot_label, slot_w, labels_l, weights, nw_l, cap, salt,
                label_range=label_range,
            )
            barred = ~fully
        else:
            in_range = (seg >= 0) & (seg < n_loc)
            best, best_w, w_cur = sort_rate(torch.where(in_range, seg, -1))
        best = torch.where(barred, -1, best)
        best_w = torch.where(barred, INT32_MIN, best_w)
    elif engine == "dense":
        conn = dense_block_ratings(sh.row_start, sh.row_end, st.dstloc_c,
                                   ew, lab_tab, n_loc, C)
        allowed = None
        if cfg.dist_local_only:
            col = torch.arange(C, dtype=_I32, device=dev)
            allowed = (col >= offset) & (col < offset + n_loc)
        best, best_w, w_cur = best_from_dense(
            conn, labels_l, weights, nw_l, cap, salt, allowed=allowed)
    elif engine == "hash":
        slot_label, slot_w = hashed_rating_table(seg, nb, ew, n_loc,
                                                 cfg.num_slots, salt)
        label_range = ((offset, offset + n_loc) if cfg.dist_local_only
                       else None)
        best, best_w = best_from_rating_table(
            slot_label, slot_w, labels_l, weights, nw_l, cap,
            int(salt) ^ 0x51AB, label_range=label_range,
        )
        w_cur = connection_to_own_label(seg, nb, ew, labels_l, n_loc)
    else:  # sort
        best, best_w, w_cur = sort_rate(seg)
    return best, best_w, w_cur, barred, nb


def _dist_lp_loop(graph: DistGraph, labels0: torch.Tensor,
                  weights0: torch.Tensor, cap: torch.Tensor, seed: int,
                  cfg: LPConfig, iters: int,
                  movable: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The round loop; returns the gathered labels [n_pad] (mesh device)."""
    mesh = graph.mesh
    home = mesh.device
    n_loc, g_loc, D = graph.n_loc, graph.g_loc, graph.num_devices
    n = graph.n
    C = weights0.shape[0]
    if cfg.rating == "sort2":
        raise ValueError(
            "rating='sort2' is not available on the distributed path; "
            "use 'scatter', 'hash', 'sort', or 'auto'"
        )
    engine, _ = select_engine(cfg.rating, C, n_loc, graph.m_loc,
                              num_slots=cfg.num_slots, row_spans=False)
    if movable is None:
        movable = torch.ones(graph.n_pad, dtype=torch.bool, device=home)
    labels0 = labels0.to(home).to(_I32)
    states = [_ShardState(sh, n_loc, g_loc, labels0, movable)
              for sh in graph.shards()]
    weights = weights0.to(home).to(ACC_DTYPE)
    cap = cap.to(home).to(ACC_DTYPE)
    participation = int(cfg.participation * 2147483647.0)

    def on(t, st):
        return t.to(st.labels.device)

    prep = None
    if engine == "scatter" and iters > 0:
        prep = [_scatter_prepare(st, cfg, _salt(seed, 0), C)
                for st in states]
        terms = torch.stack([on(t, states[0]) for _, t in prep]).tolist()
        choose = [_use_scatter(a, b, cfg.scatter_fallback) for a, b in terms]
    i, moved = 0, 1
    while i < iters and moved != 0:
        salt = _salt(seed, i)
        # -- 1. rate and select, per shard
        sel = []
        for d, st in enumerate(states):
            w_d, cap_d = on(weights, st), on(cap, st)
            best, best_w, w_cur, barred, nb = _rate(
                st, cfg, engine, salt, w_d, cap_d, C,
                prep=None if prep is None else prep[d][0],
                use_scatter=True if prep is None else choose[d],
            )
            labels_l = st.labels
            gain = best_w - w_cur
            tie_ok = hash_u32(best, salt ^ 0x5BD1) < hash_u32(
                labels_l, salt ^ 0x5BD1)
            if cfg.refinement:
                improves = gain > 0
            else:
                improves = (gain > 0) | (
                    cfg.allow_tie_moves & (gain == 0) & (best_w > 0)
                    & tie_ok)
            participate = hash_u32(st.node_ids, salt ^ 0x27D4) < (
                participation)
            wants = ((best >= 0) & (best != labels_l) & improves
                     & st.active & st.movable & (st.node_ids < n))
            target = torch.where(wants & participate, best, -1)
            sel.append([gain, wants, target, barred, nb])
        if cfg.refinement:
            cands = [torch.stack([torch.where(s[2] >= 0, s[0], INT32_MIN),
                                  s[2]]) for s in sel]
            ghosts = halo_exchange(cands, [st.sh.send_idx for st in states],
                                   [st.sh.recv_map for st in states], g_loc)
            for st, s, cand, gh in zip(states, sel, cands, ghosts):
                gain_tab = torch.cat([cand[0], gh[0]])
                target_tab = torch.cat([cand[1], gh[1]])
                seg = st.seg
                adj = afterburner_filter(
                    seg, st.dstloc_c, st.sh.edge_w,
                    st.labels[seg.clamp(0, n_loc - 1)], s[4], gain_tab,
                    target_tab, seg, n_loc, src_order=st.sh.src,
                    dst_order=st.sh.dst,
                )
                s[2] = torch.where(adj > 0, s[2], -1)
        # -- 2. weight control
        local_caps = throttled_local_capacity(
            [s[2] for s in sel], [st.sh.node_w for st in states], weights,
            cap)
        # -- 3. commit, halo sync, weight deltas
        accepts, new_labels, moved_l = [], [], []
        for st, s, lc in zip(states, sel, local_caps):
            prio = hash_u32(st.node_ids, salt ^ 0x165667B1)
            acc = accept_prefix_by_capacity(s[2], prio, st.sh.node_w, lc)
            accepts.append(acc)
            new_labels.append(torch.where(acc, s[2], st.labels))
            moved_l.append(acc.to(_I32))
        send = [st.sh.send_idx for st in states]
        recv = [st.sh.recv_map for st in states]
        if cfg.use_active_set:
            ghosts = halo_exchange(
                [torch.stack([a, b]) for a, b in zip(new_labels, moved_l)],
                send, recv, g_loc)
            new_ghost = [g[0] for g in ghosts]
            ghost_moved = [g[1] for g in ghosts]
        else:
            new_ghost = halo_exchange(new_labels, send, recv, g_loc)
        deltas = [move_weight_delta(st.labels, s[2], acc, st.sh.node_w, C)
                  for st, s, acc in zip(states, sel, accepts)]
        account_collective("psum(weight-delta)", C * 4, shape=(C,))
        weights = (weights + psum(deltas, device=home)).to(ACC_DTYPE)
        # -- 4. active set and the convergence count
        wanting = []
        for d, (st, s, acc) in enumerate(zip(states, sel, accepts)):
            if cfg.use_active_set:
                moved_tab = torch.cat([moved_l[d], ghost_moved[d]])
                neigh = segment_max(gather_i32(moved_tab, st.dstloc_c),
                                    st.seg, n_loc)
                st.active = (((moved_l[d] | neigh) > 0)
                             | (s[1] & ~acc) | (s[3] & st.active))
            wanting.append(s[1].sum(dtype=_I32))
            st.labels = new_labels[d]
            st.ghost = new_ghost[d]
        account_collective("psum(convergence)", 4, shape=())
        total = psum(wanting, device=home)
        i += 1
        if engine == "scatter" and i < iters:
            prep = [_scatter_prepare(st, cfg, _salt(seed, i), C)
                    for st in states]
            vals = torch.cat([total.reshape(1)] + [
                t.to(home) for _, t in prep]).tolist()
            moved = vals[0]
            choose = [_use_scatter(vals[1 + 2 * d], vals[2 + 2 * d],
                                   cfg.scatter_fallback) for d in range(D)]
        else:
            moved = int(total)
    account_collective("all_gather(labels)", n_loc * 4, shape=(n_loc,))
    return all_gather([st.labels for st in states], device=home)


def dist_lp_cluster(graph: DistGraph, max_cluster_weight, seed,
                    cfg: LPConfig = LPConfig(),
                    num_iterations: Optional[int] = None) -> torch.Tensor:
    """Distributed size-constrained LP clustering; i32[n_pad] labels."""
    home = graph.mesh.device
    n_pad = graph.n_pad
    labels0 = torch.arange(n_pad, dtype=_I32, device=home)
    weights0 = graph.node_w.to(ACC_DTYPE)
    cap = torch.full((n_pad,), int(max_cluster_weight), dtype=ACC_DTYPE,
                     device=home)
    iters = cfg.num_iterations if num_iterations is None else num_iterations
    return _dist_lp_loop(graph, labels0, weights0, cap, int(seed), cfg,
                         iters)


def dist_lp_cluster_from(graph: DistGraph, labels0, movable,
                         max_cluster_weight, seed,
                         cfg: LPConfig = LPConfig(),
                         num_iterations: Optional[int] = None
                         ) -> torch.Tensor:
    """LP clustering from a given clustering, nodes with movable == False
    frozen (the HEM+LP hybrid's second stage)."""
    home = graph.mesh.device
    n_pad = graph.n_pad
    labels0 = torch.as_tensor(labels0).to(home).to(_I32)
    weights0 = segment_sum(graph.node_w.to(ACC_DTYPE),
                           labels0.clamp(0, n_pad - 1), n_pad)
    cap = torch.full((n_pad,), int(max_cluster_weight), dtype=ACC_DTYPE,
                     device=home)
    iters = cfg.num_iterations if num_iterations is None else num_iterations
    return _dist_lp_loop(graph, labels0, weights0, cap, int(seed), cfg,
                         iters, movable=torch.as_tensor(movable).to(home))


def dist_lp_refine(graph: DistGraph, partition, k: int, max_block_weights,
                   seed, cfg: LPConfig = LPConfig(refinement=True),
                   num_iterations: Optional[int] = None) -> torch.Tensor:
    """Distributed LP refinement: k fixed blocks, strictly positive gains
    under per-block max weights."""
    if not cfg.refinement:
        cfg = dataclasses.replace(cfg, refinement=True,
                                  allow_tie_moves=False)
    home = graph.mesh.device
    part0 = torch.as_tensor(partition).to(home).clamp(0, k - 1).to(_I32)
    n_loc = graph.n_loc
    bws = [
        segment_sum(sh.node_w.to(ACC_DTYPE),
                    part0[sh.offset: sh.offset + n_loc].to(sh.src.device), k)
        for sh in graph.shards()
    ]
    bw0 = psum(bws, device=home)
    cap = torch.as_tensor(max_block_weights).to(home).to(ACC_DTYPE)
    iters = cfg.num_iterations if num_iterations is None else num_iterations
    return _dist_lp_loop(graph, part0, bw0, cap, int(seed), cfg, iters)


def dist_singleton_postpasses(host_graph, labels, max_cluster_weight: int,
                              threshold: float = 0.5, materialize=None):
    """Two-hop and isolated-node post-passes on the gathered labels, on the
    host (the JAX package's numpy passes, verbatim): singletons sharing a
    favoured cluster, and isolated nodes, merge into weight-capped bins;
    only when the singleton fraction exceeds `threshold`.  Returns a
    numpy copy of the labels."""
    cap = max(int(max_cluster_weight), 1)
    n = host_graph.n
    full = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
            else np.asarray(labels))
    lab = np.asarray(full[:n], dtype=np.int64).copy()
    node_w = host_graph.node_weight_array().astype(np.int64)
    sizes = np.bincount(lab, minlength=n)
    is_singleton = (lab == np.arange(n)) & (sizes[np.arange(n)] == 1)
    if is_singleton.sum() < threshold * n:
        out = np.asarray(full).copy()
        out[:n] = lab
        return out
    if materialize is not None:
        host_graph = materialize()
    elif not hasattr(host_graph, "edge_sources"):
        host_graph = host_graph.decode()

    def _bin_merge(ids: np.ndarray, group: np.ndarray) -> None:
        if len(ids) == 0:
            return
        order = np.lexsort((ids, group))
        ids_s, grp_s = ids[order], group[order]
        w = node_w[ids_s]
        csum = np.cumsum(w)
        firstg = np.ones(len(ids_s), dtype=bool)
        firstg[1:] = grp_s[1:] != grp_s[:-1]
        base = np.where(firstg, csum - w, 0)
        np.maximum.accumulate(base, out=base)
        within = csum - base
        sub = (within - w) // cap
        firstb = firstg | np.concatenate([[True], sub[1:] != sub[:-1]])
        base_b = np.where(firstb, csum - w, 0)
        np.maximum.accumulate(base_b, out=base_b)
        within_b = csum - base_b
        ok = within_b <= cap
        idx = np.arange(len(ids_s))
        lead = np.where(firstb & ok, idx, -1)
        np.maximum.accumulate(lead, out=lead)
        do = ok & (lead >= 0)
        lead_ids = ids_s[np.clip(lead, 0, len(ids_s) - 1)]
        do &= lead_ids != ids_s
        lab[ids_s[do]] = lab[lead_ids[do]]

    deg = host_graph.degrees()
    iso_ids = np.flatnonzero(is_singleton & (deg == 0))
    _bin_merge(iso_ids, np.zeros(len(iso_ids), dtype=np.int64))

    sing_ids = np.flatnonzero(is_singleton & (deg > 0))
    if len(sing_ids):
        src = host_graph.edge_sources()
        ew = host_graph.edge_weight_array().astype(np.int64)
        sing_mask = np.zeros(n, dtype=bool)
        sing_mask[sing_ids] = True
        keep = sing_mask[src]
        s, c, w = src[keep], lab[host_graph.adjncy[keep]], ew[keep]
        key = s.astype(np.int64) * n + c
        order = np.argsort(key, kind="stable")
        key_s, s_s, c_s, w_s = key[order], s[order], c[order], w[order]
        if len(key_s):
            new_grp = np.empty(len(key_s), dtype=bool)
            new_grp[0] = True
            new_grp[1:] = key_s[1:] != key_s[:-1]
            gid = np.cumsum(new_grp) - 1
            g_w = np.bincount(gid, weights=w_s).astype(np.int64)
            g_s = s_s[new_grp]
            g_c = c_s[new_grp]
            order2 = np.lexsort((g_w, g_s))
            gs2 = g_s[order2]
            last = np.empty(len(gs2), dtype=bool)
            last[:-1] = gs2[:-1] != gs2[1:]
            last[-1] = True
            src_of_max = gs2[last]
            fav_of_max = g_c[order2][last]
            fav = fav_of_max[np.searchsorted(src_of_max, sing_ids)]
            _bin_merge(sing_ids, fav)

    out = np.asarray(full).copy()
    out[:n] = lab
    return out


__all__: List[str] = [
    "dist_lp_cluster",
    "dist_lp_cluster_from",
    "dist_lp_refine",
    "dist_singleton_postpasses",
]
