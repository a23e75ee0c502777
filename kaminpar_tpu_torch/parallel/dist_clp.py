"""Distributed colored LP refinement over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_clp.py, the reference's clp_refiner.cc): one
color class of a greedy coloring per superstep, so the gains computed at
a superstep's start stay exact for every node it moves.  Per superstep
the class rates its adjacent blocks (K1 gathers the neighbour blocks),
selects positive-gain moves under the block caps, commits them under the
psum'd demand throttle of dist_lp, and one halo exchange and one psum of
block-weight deltas republish the state.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dtypes import ACC_DTYPE
from ..ops.gather import gather_i32
from ..ops.segments import (
    accept_prefix_by_capacity,
    aggregate_by_key,
    argmax_per_segment,
    connection_to_label,
    hash_u32,
    move_weight_delta,
    segment_sum,
)
from .dist_coloring import dist_greedy_coloring
from .dist_graph import DistGraph
from .mesh import (
    account_collective,
    all_gather,
    halo_exchange,
    psum,
    throttled_local_capacity,
)

_I32 = torch.int32


def dist_colored_lp_refine(graph: DistGraph, partition, k: int,
                           max_block_weights, seed, num_iterations: int = 5,
                           colors: Optional[torch.Tensor] = None,
                           num_colors: Optional[int] = None
                           ) -> torch.Tensor:
    """Colored LP refinement: a greedy coloring (unless given), then
    `num_iterations` sweeps over the color classes.  Returns the gathered
    partition [n_pad]."""
    if colors is None or num_colors is None:
        colors, num_colors = dist_greedy_coloring(graph, seed)
    home = graph.mesh.device
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    part0 = torch.as_tensor(partition).to(home).to(_I32).clamp(0, k - 1)
    cap = torch.as_tensor(max_block_weights).to(home).to(ACC_DTYPE)
    colors = torch.as_tensor(colors).to(home)
    shards = graph.shards()
    send = [sh.send_idx for sh in shards]
    recv = [sh.recv_map for sh in shards]
    parts, ghosts, st = [], [], []
    for sh in shards:
        dev = sh.src.device
        parts.append(part0[sh.offset: sh.offset + n_loc].to(dev))
        ghosts.append(gather_i32(part0, sh.ghost_gid.to(home).clamp(
            0, part0.shape[0] - 1)).to(dev))
        st.append({
            "ids": sh.offset + torch.arange(n_loc, dtype=_I32, device=dev),
            "seg": sh.src - sh.offset,
            "dl": sh.dst_local.clamp(0, n_loc + g_loc - 1),
            "colors": colors[sh.offset: sh.offset + n_loc].to(dev),
        })
    bw = psum([segment_sum(sh.node_w.to(ACC_DTYPE), p.clamp(0, k - 1), k)
               for sh, p in zip(shards, parts)], device=home)
    for i in range(num_iterations):
        for c in range(int(num_colors)):
            salt = (int(seed) * 48271 + i * 16807
                    + c * 1566083941) & 0x7FFFFFFF
            targets = []
            for sh, p, g, s in zip(shards, parts, ghosts, st):
                dev = sh.src.device
                bw_d, cap_d = bw.to(dev), cap.to(dev)
                nw_l = sh.node_w
                eligible = (s["colors"] == c) & (s["ids"] < n)
                nb = gather_i32(torch.cat([p, g]), s["dl"])
                seg_g, key_g, w_g = aggregate_by_key(s["seg"], nb, sh.edge_w)
                key_c = key_g.clamp(0, k - 1)
                seg_c = seg_g.clamp(0, n_loc - 1)
                fits = (bw_d[key_c] + nw_l[seg_c].to(ACC_DTYPE)
                        <= cap_d[key_c])
                feasible = (seg_g >= 0) & ((key_g == p[seg_c]) | fits)
                best, best_w = argmax_per_segment(
                    seg_g, key_g, w_g, n_loc, tie_salt=salt,
                    feasible=feasible)
                w_cur = connection_to_label(seg_g, key_g, w_g, p, n_loc)
                wants = (eligible & (best >= 0) & (best != p)
                         & (best_w - w_cur > 0))
                targets.append(torch.where(wants, best, -1).to(_I32))
            local_caps = throttled_local_capacity(
                targets, [sh.node_w for sh in shards], bw, cap)
            new_parts, deltas = [], []
            for sh, p, s, t, lc in zip(shards, parts, st, targets,
                                       local_caps):
                prio = hash_u32(s["ids"], salt ^ 0x165667B1)
                acc = accept_prefix_by_capacity(t, prio, sh.node_w, lc)
                new_parts.append(torch.where(acc, t, p))
                deltas.append(move_weight_delta(p, t, acc, sh.node_w, k))
            ghosts = halo_exchange(new_parts, send, recv, g_loc)
            parts = new_parts
            bw = bw + psum(deltas, device=home)
    account_collective("all_gather(partition)", n_loc * 4, shape=(n_loc,))
    return all_gather(parts, device=home)


__all__ = ["dist_colored_lp_refine"]
