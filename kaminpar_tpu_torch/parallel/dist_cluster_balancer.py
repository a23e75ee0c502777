"""Distributed cluster balancer over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_cluster_balancer.py, the reference's
cluster_balancer.cc): where single-node moves cannot rebalance a block,
whole move clusters go at once.

A round: each shard grows clusters of its owned nodes of overloaded
blocks (a few LP-style merge rounds, clusters never span shards or
blocks, no heavier than the block's shed limit), rates each cluster
against its adjacent blocks (K1 gathers the neighbour blocks), takes its
top-T clusters by relative gain into the shared top-T commit of the node
balancer, and moves the accepted clusters' members; a halo exchange
republishes the blocks.  One readback of (moved, still overloaded) per
round.
"""

from __future__ import annotations

import torch

from ..dtypes import ACC_DTYPE
from ..ops.balancer import relative_gain_key
from ..ops.gather import gather_i32
from ..ops.segments import (
    accept_prefix_by_capacity,
    aggregate_by_key,
    argmax_per_segment,
    hash_u32,
    segment_max,
    segment_sum,
)
from .dist_balancer import BalanceState, topk_candidate_commit
from .dist_graph import DistGraph
from .mesh import all_gather, halo_exchange

_I32 = torch.int32

CLUSTER_CANDIDATES_PER_DEVICE = 2048


def _build_local_clusters(sh, part_l, part_tab_nb, in_overloaded,
                          limit_of_block, k, salt, merge_rounds, n_loc):
    """Move clusters of one shard's owned overloaded-block nodes: labels
    in global id space (a leader owned by the shard, in its own block;
    -1 for non-participants) and each leader slot's cluster weight."""
    offset = sh.offset
    dev = sh.src.device
    node_ids = offset + torch.arange(n_loc, dtype=_I32, device=dev)
    src, dst, ew, nw = sh.src, sh.dst, sh.edge_w, sh.node_w
    dst_is_local = (dst >= offset) & (dst < offset + n_loc)
    seg = (src - offset).clamp(0, n_loc - 1)
    dst_slot = (dst - offset).clamp(0, n_loc - 1)
    labels = torch.where(in_overloaded, node_ids, -1).to(_I32)
    cw = torch.where(in_overloaded, nw, 0).to(ACC_DTYPE)
    limit_l = limit_of_block[part_l.clamp(0, k - 1).long()]
    same_block = dst_is_local & (part_tab_nb == part_l[seg.long()])
    for i in range(merge_rounds):
        rsalt = (int(salt) + i * 0x9E37) & 0x7FFFFFFF
        lab_src = labels[seg.long()]
        lab_dst = torch.where(dst_is_local, gather_i32(labels, dst_slot), -1)
        key = torch.where(same_block & (lab_dst >= 0) & (lab_src >= 0)
                          & (lab_dst != lab_src), lab_dst, -1)
        seg_m = torch.where(key >= 0, lab_src - offset, -1)
        seg_g, key_g, w_g = aggregate_by_key(seg_m, key, ew)
        seg_gc = seg_g.clamp(0, n_loc - 1).long()
        my_lab = seg_g + offset
        fits = (cw[(key_g - offset).clamp(0, n_loc - 1).long()] + cw[seg_gc]
                <= limit_l[seg_gc])
        dir_ok = hash_u32(key_g, rsalt) < hash_u32(my_lab, rsalt)
        feasible = (seg_g >= 0) & (key_g >= 0) & fits & dir_ok
        best, _ = argmax_per_segment(seg_g, key_g, w_g, n_loc,
                                     tie_salt=rsalt, feasible=feasible)
        wants = (labels == node_ids) & (best >= 0)
        headroom = (limit_l - cw).clamp(min=0)
        target_slot = torch.where(wants, best - offset, -1)
        prio = hash_u32(node_ids, rsalt ^ 0x7F4A7C15)
        accept = accept_prefix_by_capacity(target_slot, prio, cw, headroom)
        accept = accept & ~accept[(best - offset).clamp(0, n_loc - 1).long()]
        new_leader = torch.where(accept, best, node_ids)
        lab_c = (labels - offset).clamp(0, n_loc - 1).long()
        labels = torch.where(labels >= 0, new_leader[lab_c], labels).to(_I32)
        cw = segment_sum(torch.where(labels >= 0, nw, 0).to(ACC_DTYPE),
                         (labels - offset).clamp(0, n_loc - 1), n_loc)
    return labels, cw


def dist_cluster_balance_round(st: BalanceState, k: int, cap: torch.Tensor,
                               salt: int, merge_rounds: int):
    """One cluster-balancing round over every shard; updates `st` and
    returns (moved, still overloaded) as device scalars, unread."""
    graph = st.graph
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    shards = st.shards
    bw = st.block_weights(k)
    overload = (bw - cap).clamp(min=0)
    headroom = (cap - bw).clamp(min=0)
    limit_of_block = torch.minimum(overload, headroom.max()).clamp(min=1)
    fallback = torch.argmax(headroom).to(_I32)
    targets, orders, cwcs, built = [], [], [], []
    for d, sh in enumerate(shards):
        dev = sh.src.device
        part_l = st.parts[d]
        ov, hr = overload.to(dev), headroom.to(dev)
        fb = fallback.to(dev)
        offset = sh.offset
        node_ids = st.ids[d]
        in_over = (ov[part_l.clamp(0, k - 1).long()] > 0) & (node_ids < n)
        part_tab = torch.cat([part_l, st.ghosts[d]])
        part_nb = gather_i32(part_tab, st.dstlocs[d])
        labels, cw = _build_local_clusters(
            sh, part_l, part_nb, in_over, limit_of_block.to(dev), k, salt,
            merge_rounds, n_loc)
        seg_c = st.segs[d].clamp(0, n_loc - 1)
        lab_src = labels[seg_c.long()]
        dst_is_local = (sh.dst >= offset) & (sh.dst < offset + n_loc)
        lab_dst = torch.where(
            dst_is_local,
            gather_i32(labels, (sh.dst - offset).clamp(0, n_loc - 1)), -2)
        intra = (lab_src >= 0) & (lab_dst == lab_src)
        leader_slot = torch.where(lab_src >= 0, lab_src - offset, -1)
        key_block = torch.where((lab_src >= 0) & ~intra & (sh.dst < n),
                                part_nb, -1)
        seg_m = torch.where(key_block >= 0, leader_slot, -1)
        seg_g, key_g, w_g = aggregate_by_key(seg_m, key_block, sh.edge_w)
        seg_gc = seg_g.clamp(0, n_loc - 1).long()
        key_gc = key_g.clamp(0, k - 1).long()
        own_block = part_l[seg_gc]
        is_leader = (labels == node_ids) & (labels >= 0)
        tgt_ok = ((seg_g >= 0) & (key_g >= 0) & (key_g != own_block)
                  & (ov[key_gc] == 0) & (cw[seg_gc] <= hr[key_gc]))
        best, best_w = argmax_per_segment(
            seg_g, key_g, w_g, n_loc, tie_salt=int(salt) ^ 0x2545F,
            feasible=tgt_ok)
        own_match = (seg_g >= 0) & (key_g == own_block)
        w_own = segment_max(torch.where(own_match, w_g, 0),
                            torch.where(own_match, seg_g, n_loc),
                            n_loc + 1)[:n_loc].clamp(min=0)
        fb_ok = ((cw <= hr[fb.long()]) & (fb != part_l)
                 & (ov[fb.long()] == 0))
        use_fb = (best < 0) & fb_ok
        target = torch.where(use_fb, fb, best).to(_I32)
        gain = torch.where(use_fb, -w_own, best_w - w_own)
        cand = is_leader & (target >= 0)
        target = torch.where(cand, target, -1)
        gain = torch.where(cand, gain, 0)
        cwc = torch.where(cand, cw, 0)
        targets.append(target)
        orders.append(-relative_gain_key(gain, cwc))
        cwcs.append(cwc)
        built.append(labels)
    T = min(CLUSTER_CANDIDATES_PER_DEVICE, n_loc)
    rows, accept, cw_g, tgt_g, src_block = topk_candidate_commit(
        targets, orders, cwcs, st.parts, overload, headroom, T, k)
    new_parts = []
    for d, (do, tgt_T, lid_T) in enumerate(rows):
        part_l, labels = st.parts[d], built[d]
        dev = part_l.device
        li = lid_T.long()
        accepted = torch.zeros(n_loc, dtype=torch.bool, device=dev)
        accepted[li] = do
        tgt_of_leader = torch.full((n_loc,), -1, dtype=_I32, device=dev)
        tgt_of_leader[li] = torch.where(do, tgt_T, -1).to(_I32)
        lab_slot = (labels - shards[d].offset).clamp(0, n_loc - 1).long()
        member_moves = (labels >= 0) & accepted[lab_slot]
        new_parts.append(torch.where(
            member_moves, tgt_of_leader[lab_slot].clamp(0, k - 1), part_l))
    st.ghosts = halo_exchange(new_parts, [sh.send_idx for sh in shards],
                              [sh.recv_map for sh in shards], g_loc)
    st.parts = new_parts
    moved_w = torch.where(accept, cw_g, 0).to(ACC_DTYPE)
    delta_in = segment_sum(moved_w, tgt_g.clamp(0, k - 1), k)
    delta_out = segment_sum(moved_w, src_block.clamp(0, k - 1), k)
    return (accept.sum(dtype=_I32),
            (bw - delta_out + delta_in > cap).any())


def dist_cluster_balance(graph: DistGraph, partition, k: int,
                         max_block_weights, seed, max_rounds: int = 8,
                         merge_rounds: int = 3) -> torch.Tensor:
    """Rebalance by moving whole clusters of nodes (ClusterBalancer
    analog); a no-op on feasible partitions.  Returns the gathered
    partition."""
    home = graph.mesh.device
    st = BalanceState(graph, torch.as_tensor(partition))
    cap = torch.as_tensor(max_block_weights).to(home).to(ACC_DTYPE)
    i, moved, still = 0, 1, True
    while i < max_rounds and moved != 0 and still:
        salt = (int(seed) * 48611 + i * 104729) & 0x7FFFFFFF
        moved_t, still_t = dist_cluster_balance_round(st, k, cap, salt,
                                                      merge_rounds)
        moved, still = torch.stack([moved_t, still_t.to(_I32)]).tolist()
        i += 1
    return all_gather(st.parts, device=home)


__all__ = ["dist_cluster_balance", "dist_cluster_balance_round"]
