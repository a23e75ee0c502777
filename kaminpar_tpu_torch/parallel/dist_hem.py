"""Distributed heavy-edge matching clustering over the shard mesh
(counterpart of kaminpar_tpu/parallel/dist_hem.py, the reference's
HEMClusterer): bulk-synchronous handshake rounds, every unmatched node
proposes to its heaviest available neighbour under the weight cap and
mutual proposals match, labelled min(u, v).  Halo exchanges publish the
proposals and the availability each round.  `dist_hem_lp_cluster` is the
HEM+LP hybrid: matching, then LP with the matched pairs frozen.
"""

from __future__ import annotations

import torch

from ..dtypes import ACC_DTYPE
from ..ops.gather import gather_i32
from ..ops.lp import LPConfig
from ..ops.segments import aggregate_by_key, argmax_per_segment
from .dist_graph import DistGraph
from .mesh import all_gather, halo_exchange

_I32 = torch.int32


def dist_hem_cluster(graph: DistGraph, max_cluster_weight, seed,
                     num_rounds: int = 5) -> torch.Tensor:
    """Heavy-edge matching clustering: i32[n_pad] labels, matched pairs
    share min(u, v), unmatched nodes stay singletons."""
    home = graph.mesh.device
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    cap = int(max_cluster_weight)
    shards = graph.shards()
    send = [sh.send_idx for sh in shards]
    recv = [sh.recv_map for sh in shards]
    per = []
    for sh in shards:
        dev = sh.src.device
        ids = sh.offset + torch.arange(n_loc, dtype=_I32, device=dev)
        per.append({"ids": ids, "real": ids < n, "seg": sh.src - sh.offset,
                    "dl": sh.dst_local.clamp(0, n_loc + g_loc - 1)})
    ghost_nw = halo_exchange([sh.node_w for sh in shards], send, recv, g_loc)
    for p, sh, gnw in zip(per, shards, ghost_nw):
        p["nw_tab"] = torch.cat([sh.node_w, gnw])
    labels = [p["ids"].clone() for p in per]
    avail = [p["real"].to(_I32) for p in per]
    ghost_avail = halo_exchange(avail, send, recv, g_loc)
    for rnd in range(num_rounds):
        salt = (int(seed) * 69621 + rnd * 7919) & 0x7FFFFFFF
        props, slots, proposes_l = [], [], []
        for sh, p, av, gav in zip(shards, per, avail, ghost_avail):
            avail_tab = torch.cat([av, gav])
            seg_g, key_g, w_g = aggregate_by_key(p["seg"], p["dl"],
                                                 sh.edge_w)
            key_c = key_g.clamp(0, n_loc + g_loc - 1).long()
            feas = ((avail_tab[key_c] > 0)
                    & (p["nw_tab"][key_c].to(ACC_DTYPE)
                       + sh.node_w[seg_g.clamp(0, n_loc - 1).long()].to(
                           ACC_DTYPE) <= cap)
                    & (seg_g >= 0))
            prop_slot, _ = argmax_per_segment(seg_g, key_g, w_g, n_loc,
                                              tie_salt=salt, feasible=feas)
            proposes = (av > 0) & p["real"] & (prop_slot >= 0)
            ghost_id = sh.ghost_gid[
                (prop_slot - n_loc).clamp(0, g_loc - 1).long()]
            prop_gid = torch.where(
                proposes,
                torch.where(prop_slot < n_loc, sh.offset + prop_slot,
                            ghost_id), -1).to(_I32)
            props.append(prop_gid)
            slots.append(prop_slot.clamp(0, n_loc + g_loc - 1))
            proposes_l.append(proposes)
        ghost_prop = halo_exchange(props, send, recv, g_loc)
        new_avail = []
        for d, p in enumerate(per):
            prop_tab = torch.cat([props[d], ghost_prop[d]])
            partner = torch.where(
                proposes_l[d] & (gather_i32(prop_tab, slots[d]) == p["ids"]),
                props[d], -1)
            matched = partner >= 0
            labels[d] = torch.where(matched,
                                    torch.minimum(p["ids"], partner),
                                    labels[d]).to(_I32)
            new_avail.append(torch.where(matched, 0, avail[d]).to(_I32))
        avail = new_avail
        ghost_avail = halo_exchange(avail, send, recv, g_loc)
    return all_gather(labels, device=home)


def dist_hem_lp_cluster(graph: DistGraph, max_cluster_weight, seed,
                        hem_rounds: int = 5, cfg: LPConfig = LPConfig()
                        ) -> torch.Tensor:
    """HEM, then LP with the matched pairs frozen (HEMLPClusterer
    analog)."""
    from .dist_lp import dist_lp_cluster_from

    labels = dist_hem_cluster(graph, max_cluster_weight, seed,
                              num_rounds=hem_rounds)
    n_pad = graph.n_pad
    movable = labels == torch.arange(n_pad, dtype=_I32, device=labels.device)
    adopted = torch.zeros(n_pad, dtype=_I32, device=labels.device)
    adopted.scatter_reduce_(0, labels.clamp(0, n_pad - 1).long(),
                            (~movable).to(_I32), "amax", include_self=True)
    movable = movable & (adopted == 0)
    return dist_lp_cluster_from(graph, labels, movable, max_cluster_weight,
                                seed, cfg)


__all__ = ["dist_hem_cluster", "dist_hem_lp_cluster"]
