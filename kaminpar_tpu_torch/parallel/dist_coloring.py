"""Distributed greedy node coloring over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_coloring.py, the reference's
greedy_node_coloring.h): Jones-Plassmann rounds, in round r every
uncolored node whose hashed priority is a strict local minimum among its
uncolored neighbours takes color r, so each color class is an
independent set.  A halo exchange publishes the new colors each round;
the psum'd count of uncolored nodes ends the loop (one readback per
round).  Nodes still uncolored after `max_rounds` each get a fresh color.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dtypes import INT32_MAX
from ..ops.gather import gather_i32
from ..ops.segments import hash_u32, segment_min
from .dist_graph import DistGraph
from .mesh import all_gather, halo_exchange, psum

_I32 = torch.int32


def dist_greedy_coloring(graph: DistGraph, seed, max_rounds: int = 512
                         ) -> Tuple[torch.Tensor, int]:
    """Color the sharded graph; returns (colors i32[n_pad], num_colors).
    Pad nodes keep color -1."""
    home = graph.mesh.device
    n_loc, g_loc, n = graph.n_loc, graph.g_loc, graph.n
    seed = int(seed) & 0xFFFFFFFF
    shards = graph.shards()
    per = []
    for sh in shards:
        dev = sh.src.device
        ids = sh.offset + torch.arange(n_loc, dtype=_I32, device=dev)
        per.append({
            "ids": ids, "real": ids < n,
            "seg_c": (sh.src - sh.offset).clamp(0, n_loc - 1),
            "dl": sh.dst_local.clamp(0, n_loc + g_loc - 1),
            "prio": hash_u32(ids, seed),
            "nprio": hash_u32(sh.dst, seed),
        })
    colors = [torch.full((n_loc,), -1, dtype=_I32, device=p["ids"].device)
              for p in per]
    ghosts = [torch.full((g_loc,), -1, dtype=_I32, device=p["ids"].device)
              for p in per]
    rnd, uncolored = 0, 1
    while rnd < max_rounds and uncolored != 0:
        new_colors = []
        for sh, p, col, gh in zip(shards, per, colors, ghosts):
            un = (col < 0) & p["real"]
            tab = torch.cat([col, gh])
            neigh_un = (gather_i32(tab, p["dl"]) < 0) & (sh.dst < n)
            neigh_prio = torch.where(neigh_un, p["nprio"], INT32_MAX)
            min_p = segment_min(neigh_prio, p["seg_c"], n_loc)
            at_min = neigh_un & (neigh_prio == min_p[p["seg_c"].long()])
            min_id = segment_min(torch.where(at_min, sh.dst, INT32_MAX),
                                 p["seg_c"], n_loc)
            winner = un & ((p["prio"] < min_p)
                           | ((p["prio"] == min_p) & (p["ids"] < min_id)))
            new_colors.append(torch.where(winner, rnd, col).to(_I32))
        ghosts = halo_exchange(new_colors, [sh.send_idx for sh in shards],
                               [sh.recv_map for sh in shards], g_loc)
        colors = new_colors
        uncolored = int(psum([((c < 0) & p["real"]).sum(dtype=_I32)
                              for c, p in zip(colors, per)], device=home))
        rnd += 1
    # leftovers: a fresh color each, numbered in shard order
    lefts = [(c < 0) & p["real"] for c, p in zip(colors, per)]
    counts = [int(x) for x in torch.stack(
        [lf.sum(dtype=_I32).to(home) for lf in lefts]).tolist()]
    out = []
    for d, (c, lf) in enumerate(zip(colors, lefts)):
        rank = torch.cumsum(lf.to(_I32), 0, dtype=_I32) - lf.to(_I32)
        out.append(torch.where(lf, rnd + sum(counts[:d]) + rank, c))
    full = all_gather(out, device=home)
    return full, int(full.max()) + 1


__all__ = ["dist_greedy_coloring"]
