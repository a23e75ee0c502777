"""Sharded cluster contraction over the shard mesh (counterpart of
kaminpar_tpu/parallel/dist_contraction.py).

Per shard: map the edge shard to coarse endpoints (K1 gathers the labels
of both endpoints), deduplicate (cu, cv) pairs, bucket the rows by a hash
of the pair modulo D and exchange the buckets with one all_to_all; each
shard then merges the rows it received.  The host assembles the coarse
CSR from the shards' disjoint pair sets.  The driver takes this path only
above ``segments.MAX_FUSED_EDGE_SLOTS`` edges.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..dtypes import ACC_DTYPE
from ..graphs.host import HostGraph
from ..ops.gather import gather_i32
from ..ops.segments import aggregate_by_key, hash_u32, segment_min, stable_order
from .dist_graph import DistGraph
from .mesh import account_collective, all_to_all, psum

_I32 = torch.int32

# output rows per shard = OUT_FACTOR * m_loc; an overflow raises
OUT_FACTOR = 2
# per-peer bucket capacity = max(m_loc * BUCKET_SLACK // D, BUCKET_MIN)
BUCKET_SLACK = 4
BUCKET_MIN = 1 << 16


def _contract_edges(graph: DistGraph, labels: torch.Tensor,
                    cmap_full: torch.Tensor):
    D = graph.num_devices
    n_pad, n = graph.n_pad, graph.n
    home = graph.mesh.device
    cap = graph.m_loc
    bcap = max(cap * BUCKET_SLACK // D, BUCKET_MIN)
    big = n_pad
    sends, overflows, devs = [], [], []
    for sh in graph.shards():
        dev = sh.src.device
        lab, cm = labels.to(dev), cmap_full.to(dev)
        lab_src = gather_i32(lab, sh.src.clamp(0, n_pad - 1))
        lab_dst = gather_i32(lab, sh.dst.clamp(0, n_pad - 1))
        cu = gather_i32(cm, lab_src.clamp(0, n_pad - 1))
        cv = gather_i32(cm, lab_dst.clamp(0, n_pad - 1))
        keep = (sh.src < n) & (sh.dst < n) & (cu != cv)
        seg_g, key_g, w_g = aggregate_by_key(
            torch.where(keep, cu, big), torch.where(keep, cv, big),
            sh.edge_w)
        rows_valid = (seg_g >= 0) & (seg_g < big)
        mixed = (key_g.long() * -1640531527 + 2**31) % 2**32 - 2**31
        pair_h = hash_u32(seg_g ^ mixed.to(_I32), 0x5C0A)
        tgt = torch.where(rows_valid, pair_h % D, D).to(_I32)
        order = stable_order(tgt)
        tgt, seg_g, key_g, w_g = tgt[order], seg_g[order], key_g[order], \
            w_g[order]
        rows_valid = tgt < D
        idx = torch.arange(cap, dtype=_I32, device=dev)
        start = segment_min(torch.where(rows_valid, idx, cap), tgt, D + 1)
        pos = idx - start[tgt.clamp(0, D - 1)]
        overflows.append((rows_valid & (pos >= bcap)).sum(dtype=_I32))
        flat = torch.where(rows_valid & (pos < bcap), tgt * bcap + pos,
                           D * bcap).long()

        def to_buckets(vals, fill):
            buf = torch.full((D * bcap + 1,), fill, dtype=vals.dtype,
                             device=dev)
            buf[flat] = torch.where(rows_valid, vals, fill)
            return buf[: D * bcap].view(D, bcap)

        sends.append((to_buckets(seg_g, -1), to_buckets(key_g, -1),
                      to_buckets(w_g.to(ACC_DTYPE), 0)))
        devs.append(dev)
    account_collective("all_to_all(contraction-edges)", 3 * D * bcap * 4,
                       shape=(D, bcap))
    recv_cu = all_to_all([s[0] for s in sends], devs)
    recv_cv = all_to_all([s[1] for s in sends], devs)
    recv_w = all_to_all([s[2] for s in sends], devs)
    total_overflow = int(psum(overflows, device=home))
    out_cap = OUT_FACTOR * cap
    out = []
    for rc, rv, rw in zip(recv_cu, recv_cv, recv_w):
        seg2, cv2 = rc.reshape(-1), rv.reshape(-1)
        seg_f, key_f, w_f = aggregate_by_key(
            torch.where(seg2 >= 0, seg2, big),
            torch.where(seg2 >= 0, cv2, big), rw.reshape(-1))
        valid_f = (seg_f >= 0) & (seg_f < big)
        count = (out_cap + 1 if total_overflow > 0
                 else int(valid_f.sum()))
        out.append((seg_f[:out_cap], key_f[:out_cap], w_f[:out_cap], count))
    return out, out_cap


def dist_contract_clustering(graph: DistGraph, dg_host_n: int,
                             node_w: np.ndarray, labels
                             ) -> Tuple[HostGraph, np.ndarray]:
    """Contract a clustering of the sharded graph; returns (coarse
    HostGraph, fine->coarse cmap)."""
    n_pad = graph.n_pad
    lab = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
           else np.asarray(labels)).astype(np.int64)
    used = np.zeros(n_pad, dtype=bool)
    used[lab[:dg_host_n]] = True
    cmap_full = (np.cumsum(used) - 1).astype(np.int32)
    c_n = int(used.sum())
    cmap = cmap_full[lab[:dg_host_n]]
    home = graph.mesh.device
    shards, out_cap = _contract_edges(
        graph, torch.from_numpy(lab.astype(np.int32)).to(home),
        torch.from_numpy(cmap_full).to(home))
    counts = [s[3] for s in shards]
    if any(c > out_cap for c in counts):
        raise RuntimeError(
            "sharded contraction overflow: a migrate bucket or a shard's "
            f"merged coarse rows exceed capacity ({out_cap}); raise "
            "dist_contraction.OUT_FACTOR / BUCKET_SLACK"
        )
    g_cu = np.concatenate([s[0][: c].cpu().numpy()
                           for s, c in zip(shards, counts)])
    g_cv = np.concatenate([s[1][: c].cpu().numpy()
                           for s, c in zip(shards, counts)])
    g_w = np.concatenate([s[2][: c].cpu().numpy()
                          for s, c in zip(shards, counts)]).astype(np.int64)
    order = np.lexsort((g_cv, g_cu))
    g_cu, g_cv, g_w = g_cu[order], g_cv[order], g_w[order]
    c_node_w = np.zeros(c_n, dtype=np.int64)
    np.add.at(c_node_w, cmap, np.asarray(node_w[:dg_host_n], dtype=np.int64))
    xadj = np.zeros(c_n + 1, dtype=np.int64)
    np.add.at(xadj, g_cu.astype(np.int64) + 1, 1)
    xadj = np.cumsum(xadj)
    coarse = HostGraph(
        xadj=xadj,
        adjncy=g_cv.astype(np.int32),
        node_weights=c_node_w,
        edge_weights=(g_w if len(g_w) and not (g_w == 1).all() else None),
    )
    return coarse, cmap
