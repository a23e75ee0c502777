"""Distributed greedy node balancer over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_balancer.py).

Each round: every shard rates its owned nodes of overloaded blocks from
the ghost-halo partition (K1 gathers the neighbour blocks) and sorts out
its top-T move candidates by relative gain; the T-tuples of all shards
are gathered and one capacity-respecting two-sided prefix commit decides
(the JAX package runs it identically on every device; here it runs
once); owners apply their accepted rows and push the changed blocks to
the ghosts.  The round loop reads back (moved, still overloaded) once per
round.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..dtypes import ACC_DTYPE
from ..ops.balancer import relative_gain_key
from ..ops.gather import gather_i32
from ..ops.segments import (
    accept_prefix_by_capacity,
    aggregate_by_key,
    argmax_per_segment,
    connection_to_label,
    float_sort_key,
    segment_sum,
    stable_order,
)
from .dist_graph import DistGraph
from .mesh import account_collective, all_gather, halo_exchange, psum

_I32 = torch.int32

# per-shard candidate budget per round (the per-PE priority queue size)
BALANCER_CANDIDATES_PER_DEVICE = 4096


def topk_candidate_commit(
    targets: Sequence[torch.Tensor],
    orders: Sequence[torch.Tensor],
    ws: Sequence[torch.Tensor],
    srcbs: Sequence[torch.Tensor],
    overload: torch.Tensor,
    headroom: torch.Tensor,
    T: int,
    k: int,
):
    """The shared top-T protocol over all shards: each shard sorts its
    candidates by `orders[d]` (ascending = best; non-candidates have
    target -1), the top-T tuples are gathered in shard order, and one
    two-sided prefix commit accepts rows.  Returns per shard (accepted_T,
    tgt_T, lid_T) and the gathered (accept, w_g, tgt_g, src_block)."""
    home = overload.device
    per = []
    for tgt, order, w, srcb in zip(targets, orders, ws, srcbs):
        n_loc = tgt.shape[0]
        key = torch.where(tgt >= 0, order, torch.full_like(order,
                                                           float("inf")))
        perm = stable_order(float_sort_key(key))[:T]
        tgt_T, lid_T = tgt[perm], perm.to(_I32)
        srcb_T = torch.where(tgt_T >= 0,
                             srcb[lid_T.clamp(0, n_loc - 1).long()], -1)
        per.append((key[perm], tgt_T, w[perm], lid_T, srcb_T))
    tgt_g = all_gather([p[1] for p in per], device=home)
    key_g = all_gather([p[0] for p in per], device=home)
    w_g = all_gather([p[2] for p in per], device=home)
    srcb_g = all_gather([p[4] for p in per], device=home)
    src_block = torch.where(tgt_g >= 0, srcb_g.clamp(0, k - 1), -1)
    accept_out = accept_prefix_by_capacity(src_block, key_g, w_g, overload,
                                           reach=True)
    target2 = torch.where(accept_out, tgt_g, -1)
    accept_in = accept_prefix_by_capacity(target2, key_g, w_g, headroom)
    accept = accept_out & accept_in
    rows = []
    for d, p in enumerate(per):
        mine = accept[d * T: (d + 1) * T].to(p[1].device)
        rows.append((mine & (p[1] >= 0), p[1], p[3]))
    return rows, accept, w_g, tgt_g, src_block


class BalanceState:
    """The owner-sharded partition a balancer round works on: each shard's
    owned blocks (`parts`) and ghost blocks (`ghosts`), with its local
    edge endpoints and node ids."""

    def __init__(self, graph: DistGraph, part0: torch.Tensor):
        home = graph.mesh.device
        n_loc, g_loc = graph.n_loc, graph.g_loc
        part0 = part0.to(home).to(_I32)
        self.graph = graph
        self.shards = graph.shards()
        self.parts, self.ghosts, self.segs = [], [], []
        self.dstlocs, self.ids = [], []
        for sh in self.shards:
            dev = sh.src.device
            self.parts.append(part0[sh.offset: sh.offset + n_loc].to(dev))
            self.ghosts.append(gather_i32(part0, sh.ghost_gid.to(home).clamp(
                0, part0.shape[0] - 1)).to(dev))
            self.segs.append(sh.src - sh.offset)
            self.dstlocs.append(sh.dst_local.clamp(0, n_loc + g_loc - 1))
            self.ids.append(sh.offset + torch.arange(n_loc, dtype=_I32,
                                                     device=dev))

    def block_weights(self, k: int) -> torch.Tensor:
        """The psum'd block weights (every shard's local segment sum)."""
        return psum([segment_sum(sh.node_w.to(ACC_DTYPE),
                                 p.clamp(0, k - 1), k)
                     for sh, p in zip(self.shards, self.parts)],
                    device=self.graph.mesh.device)

    def gather(self) -> torch.Tensor:
        n_loc = self.graph.n_loc
        account_collective("all_gather(partition)", n_loc * 4,
                           shape=(n_loc,))
        return all_gather(self.parts, device=self.graph.mesh.device)


def dist_balance_round(st: BalanceState, k: int, cap: torch.Tensor,
                       salt: int):
    """One balancing round over every shard (the JAX package's per-device
    dist_balance_round): updates `st` in place and returns (moved, still
    overloaded) as device scalars, unread."""
    graph = st.graph
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    shards = st.shards
    T = min(BALANCER_CANDIDATES_PER_DEVICE, n_loc)
    bw = st.block_weights(k)
    overload = (bw - cap).clamp(min=0)
    headroom = (cap - bw).clamp(min=0)
    fallback = torch.argmax(headroom).to(_I32)
    targets, orders = [], []
    for d, sh in enumerate(shards):
        dev = sh.src.device
        part_l, nw_l = st.parts[d], sh.node_w
        ov, hr = overload.to(dev), headroom.to(dev)
        fb = fallback.to(dev)
        in_over = (ov[part_l.clamp(0, k - 1)] > 0) & (st.ids[d] < n)
        tab = torch.cat([part_l, st.ghosts[d]])
        nb = gather_i32(tab, st.dstlocs[d])
        seg_g, key_g, w_g = aggregate_by_key(st.segs[d], nb, sh.edge_w)
        key_c = key_g.clamp(0, k - 1)
        seg_c = seg_g.clamp(0, n_loc - 1)
        tgt_ok = ((seg_g >= 0) & (key_g != part_l[seg_c])
                  & (ov[key_c] == 0)
                  & (nw_l[seg_c].to(ACC_DTYPE) <= hr[key_c]))
        best, best_w = argmax_per_segment(
            seg_g, key_g, w_g, n_loc, tie_salt=salt, feasible=tgt_ok)
        w_own = connection_to_label(seg_g, key_g, w_g, part_l, n_loc)
        fallback_ok = nw_l.to(ACC_DTYPE) <= hr[fb.long()]
        use_fb = (best < 0) & fallback_ok
        target = torch.where(use_fb, fb, best).to(_I32)
        gain = torch.where(use_fb, -w_own, best_w - w_own)
        target = torch.where(in_over & (target >= 0), target, -1)
        targets.append(target)
        orders.append(-relative_gain_key(gain, nw_l))
    rows, accept, w_g, tgt_g, src_block = topk_candidate_commit(
        targets, orders, [sh.node_w for sh in shards], st.parts, overload,
        headroom, T, k)
    new_parts = []
    for d, (do, tgt_T, lid_T) in enumerate(rows):
        part_l = st.parts[d]
        li = lid_T.long()
        new = part_l.clone()
        new[li] = torch.where(do, tgt_T.clamp(0, k - 1), part_l[li])
        new_parts.append(new)
    st.ghosts = halo_exchange(new_parts, [sh.send_idx for sh in shards],
                              [sh.recv_map for sh in shards], g_loc)
    st.parts = new_parts
    moved_w = torch.where(accept, w_g, 0).to(ACC_DTYPE)
    delta_in = segment_sum(moved_w, tgt_g.clamp(0, k - 1), k)
    delta_out = segment_sum(moved_w, src_block.clamp(0, k - 1), k)
    return (accept.sum(dtype=_I32),
            (bw - delta_out + delta_in > cap).any())


def dist_node_balance(graph: DistGraph, partition, k: int,
                      max_block_weights, seed, max_rounds: int = 64
                      ) -> torch.Tensor:
    """Balance an infeasible partition on the mesh (NodeBalancer analog);
    returns the gathered partition [n_pad].  Stops once feasible or after
    a round that moved nothing."""
    home = graph.mesh.device
    st = BalanceState(graph, torch.as_tensor(partition))
    cap = torch.as_tensor(max_block_weights).to(home).to(ACC_DTYPE)
    i, moved, still = 0, 1, True
    while i < max_rounds and moved != 0 and still:
        salt = (int(seed) * 62089911 + i * 7919) & 0x7FFFFFFF
        moved_t, still_t = dist_balance_round(st, k, cap, salt)
        moved, still = torch.stack([moved_t, still_t.to(_I32)]).tolist()
        i += 1
    return st.gather()


__all__: List[str] = ["BalanceState", "dist_balance_round",
                       "dist_node_balance", "topk_candidate_commit"]
