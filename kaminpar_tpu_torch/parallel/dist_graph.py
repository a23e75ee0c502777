"""The node-sharded graph (counterpart of kaminpar_tpu/parallel/dist_graph.py).

Shard d of D owns the contiguous global node range [d*n_loc, (d+1)*n_loc)
and holds the edges whose source it owns; the layout is the JAX
package's, field for field (n_loc = n_pad / D, m_loc = the heaviest
shard's padded edge bucket):

  * ``src``/``dst``/``edge_w`` slots [d*m_loc, (d+1)*m_loc) hold shard d's
    edges (source-sorted CSR rows), then pad slots with src = the first
    owned node, dst = the global pad node n_pad - 1 and weight 0;
  * ``dst_local`` is each edge's endpoint in the shard's local index
    space: [0, n_loc) for owned nodes, n_loc + g for ghost slot g;
  * ``ghost_gid`` [D*g_loc]: the global id of each ghost slot (pad:
    n_pad - 1);
  * ``send_idx`` / ``recv_map`` [D*D, s_max]: shard d's block row p holds
    the local indices of the owned nodes peer p needs (pad -1) and the
    ghost slot of peer p's j-th value (pad g_loc).

One field is this package's own: ``row_ptr`` [D*(n_loc+1)], each shard's
CSR row offsets into its slots (pad slots lie past every span).  Pad
slots carry weight 0, so a connection table over the spans equals the
JAX package's over every slot: K2 reads the spans.

The arrays live on the mesh's first device; :meth:`DistGraph.shard`
hands out shard d's views on its own device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..caching import pad_size
from ..graphs.host import HostGraph
from ..utils.math import round_up
from .mesh import Mesh


@dataclass
class Shard:
    """Shard d's views of a DistGraph (on the shard's device)."""

    d: int
    offset: int
    src: torch.Tensor
    dst: torch.Tensor
    edge_w: torch.Tensor
    node_w: torch.Tensor
    dst_local: torch.Tensor
    ghost_gid: torch.Tensor
    send_idx: torch.Tensor  # [D, s_max]
    recv_map: torch.Tensor  # [D, s_max]
    row_start: torch.Tensor  # [n_loc]
    row_end: torch.Tensor  # [n_loc]


@dataclass
class DistGraph:
    src: torch.Tensor
    dst: torch.Tensor
    edge_w: torch.Tensor
    node_w: torch.Tensor
    n: int
    m: int
    dst_local: torch.Tensor
    ghost_gid: torch.Tensor
    send_idx: torch.Tensor
    recv_map: torch.Tensor
    row_ptr: torch.Tensor
    mesh: Mesh
    _shards: Optional[List[Shard]] = field(default=None, repr=False)

    @property
    def n_pad(self) -> int:
        return self.node_w.shape[0]

    @property
    def m_tot(self) -> int:
        return self.src.shape[0]

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def n_loc(self) -> int:
        return self.n_pad // self.num_devices

    @property
    def m_loc(self) -> int:
        return self.m_tot // self.num_devices

    @property
    def g_loc(self) -> int:
        return self.ghost_gid.shape[0] // max(self.num_devices, 1)

    @property
    def s_max(self) -> int:
        return self.send_idx.shape[1]

    def shard(self, d: int) -> Shard:
        return self.shards()[d]

    def shards(self) -> List[Shard]:
        """Every shard's views (built once, on the shards' devices)."""
        if self._shards is None:
            D, n_loc, m_loc, g_loc = (self.num_devices, self.n_loc,
                                      self.m_loc, self.g_loc)
            out = []
            for d in range(D):
                dev = self.mesh.devices[d]
                e = slice(d * m_loc, (d + 1) * m_loc)
                rp = self.row_ptr[d * (n_loc + 1): (d + 1) * (n_loc + 1)]
                out.append(Shard(
                    d=d, offset=d * n_loc,
                    src=self.src[e].to(dev),
                    dst=self.dst[e].to(dev),
                    edge_w=self.edge_w[e].to(dev),
                    node_w=self.node_w[d * n_loc: (d + 1) * n_loc].to(dev),
                    dst_local=self.dst_local[e].to(dev),
                    ghost_gid=self.ghost_gid[
                        d * g_loc: (d + 1) * g_loc].to(dev),
                    send_idx=self.send_idx[d * D: (d + 1) * D].to(dev),
                    recv_map=self.recv_map[d * D: (d + 1) * D].to(dev),
                    row_start=rp[:-1].to(dev),
                    row_end=rp[1:].to(dev),
                ))
            self._shards = out
        return self._shards


def shard_sizes(
    xadj: np.ndarray, D: int, n_pad: Optional[int] = None,
) -> Tuple[int, int, List[int]]:
    """(n_loc, m_loc, per-shard true edge counts) of the contiguous-range
    plan over D shards; m_loc is the padded bucket of the heaviest
    shard."""
    xadj = np.asarray(xadj, dtype=np.int64)
    n = len(xadj) - 1
    if n_pad is None:
        n_pad = round_up(pad_size(n + 1), D)
    else:
        n_pad = round_up(n_pad, D)
    n_loc = n_pad // D
    counts: List[int] = []
    for d in range(D):
        v0, v1 = min(d * n_loc, n), min((d + 1) * n_loc, n)
        counts.append(int(xadj[v1] - xadj[v0]))
    m_loc = pad_size(max(max(counts, default=1), 1))
    return n_loc, m_loc, counts


def shard_fingerprints(graph, D: int) -> List[str]:
    """One short hash per shard of the plan (fleet size, shard index,
    owned range, edge count, pad sizes, boundary row offsets): a resume
    under another shard count sees another vector."""
    xadj = np.asarray(graph.xadj, dtype=np.int64)
    n = len(xadj) - 1
    n_loc, m_loc, counts = shard_sizes(xadj, D)
    fps: List[str] = []
    for d in range(D):
        v0, v1 = min(d * n_loc, n), min((d + 1) * n_loc, n)
        h = hashlib.sha256()
        h.update(
            f"D={D};d={d};v0={v0};v1={v1};edges={counts[d]};"
            f"n_loc={n_loc};m_loc={m_loc};".encode()
        )
        h.update(xadj[v0: min(v1 + 1, v0 + 257)].tobytes())
        fps.append(h.hexdigest()[:16])
    return fps


def dist_graph_bytes(dg: DistGraph) -> int:
    """Device bytes of a DistGraph's JAX-layout arrays (spill accounting;
    row_ptr, this package's extra field, is not counted)."""
    total = 0
    for name in ("src", "dst", "edge_w", "node_w", "dst_local",
                 "ghost_gid", "send_idx", "recv_map"):
        arr = getattr(dg, name)
        total += arr.element_size() * arr.numel()
    return total


def dist_graph_from_host(graph: HostGraph, mesh: Mesh,
                         n_pad: Optional[int] = None) -> DistGraph:
    """Shard a host graph onto `mesh` in contiguous node ranges."""

    def rows(v0: int, v1: int):
        lo, hi = int(graph.xadj[v0]), int(graph.xadj[v1])
        ew = graph.edge_weights
        return graph.adjncy[lo:hi], (None if ew is None else ew[lo:hi])

    return _assemble_dist_graph(
        np.asarray(graph.xadj, dtype=np.int64), graph.node_weight_array(),
        rows, mesh, n_pad,
    )


def dist_graph_from_compressed(cgraph, mesh: Mesh,
                               n_pad: Optional[int] = None) -> DistGraph:
    """Shard a CompressedHostGraph, decoding one shard's node range at a
    time; equal to ``dist_graph_from_host(cgraph.decode(), mesh)``."""

    def rows(v0: int, v1: int):
        return cgraph.decode_range(v0, v1)[1:]

    return _assemble_dist_graph(
        np.asarray(cgraph.xadj, dtype=np.int64), cgraph.node_weight_array(),
        rows, mesh, n_pad,
    )


def _assemble_dist_graph(xadj, node_weights, rows, mesh: Mesh,
                         n_pad: Optional[int] = None) -> DistGraph:
    D = mesh.size
    n = len(xadj) - 1
    m = int(xadj[-1])
    n_pad = round_up(pad_size(n + 1), D) if n_pad is None else round_up(
        n_pad, D)
    if n_pad < n + 1:
        raise ValueError("n_pad too small")
    pad_node = n_pad - 1
    degrees = xadj[1:] - xadj[:-1]
    n_loc, m_loc, _ = shard_sizes(xadj, D, n_pad=n_pad)

    src_t = np.empty((D, m_loc), dtype=np.int32)
    dst_t = np.full((D, m_loc), pad_node, dtype=np.int32)
    ew_t = np.zeros((D, m_loc), dtype=np.int32)
    rp_t = np.zeros((D, n_loc + 1), dtype=np.int32)
    ghosts_per_dev = []
    for d in range(D):
        src_t[d, :] = d * n_loc
        v0, v1 = min(d * n_loc, n), min((d + 1) * n_loc, n)
        adjn, ew = rows(v0, v1)
        c = len(adjn)
        if c:
            src_t[d, :c] = np.repeat(np.arange(v0, v1, dtype=np.int32),
                                     degrees[v0:v1])
            dst_t[d, :c] = adjn
            ew_t[d, :c] = 1 if ew is None else ew
        rp = xadj[v0: v1 + 1] - xadj[v0]
        rp_t[d, : len(rp)] = rp
        rp_t[d, len(rp):] = c
        dst_d = dst_t[d]
        remote = dst_d[(dst_d < d * n_loc) | (dst_d >= (d + 1) * n_loc)]
        ghosts_per_dev.append(np.unique(remote))

    g_loc = max(1, pad_size(max((len(g) for g in ghosts_per_dev),
                                default=1), 1))
    s_needed = 1
    for d in range(D):
        gh = ghosts_per_dev[d]
        if len(gh):
            own = np.clip(gh // n_loc, 0, D - 1)
            s_needed = max(s_needed,
                           int(np.bincount(own, minlength=D).max()))
    s_max = pad_size(s_needed, 1)

    dstloc_t = np.zeros((D, m_loc), dtype=np.int32)
    ghost_gid_t = np.full((D, g_loc), pad_node, dtype=np.int32)
    send_idx_t = np.full((D, D, s_max), -1, dtype=np.int32)
    recv_map_t = np.full((D, D, s_max), g_loc, dtype=np.int32)
    for d in range(D):
        gh = ghosts_per_dev[d]
        ghost_gid_t[d, : len(gh)] = gh
        dst_d = dst_t[d]
        is_owned = (dst_d >= d * n_loc) & (dst_d < (d + 1) * n_loc)
        loc = np.where(
            is_owned, dst_d - d * n_loc,
            n_loc + np.searchsorted(gh, dst_d) if len(gh) else 0,
        )
        dstloc_t[d] = loc.astype(np.int32)
        own = np.clip(gh // n_loc, 0, D - 1) if len(gh) else np.zeros(0, int)
        for p in range(D):
            mine = np.where(own == p)[0]
            send_idx_t[p, d, : len(mine)] = (gh[mine] - p * n_loc).astype(
                np.int32)
            recv_map_t[d, p, : len(mine)] = mine.astype(np.int32)

    node_w = np.zeros(n_pad, dtype=np.int32)
    node_w[:n] = np.asarray(node_weights).astype(np.int32)
    dev = mesh.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return DistGraph(
        src=t(src_t.reshape(-1)), dst=t(dst_t.reshape(-1)),
        edge_w=t(ew_t.reshape(-1)), node_w=t(node_w), n=n, m=m,
        dst_local=t(dstloc_t.reshape(-1)),
        ghost_gid=t(ghost_gid_t.reshape(-1)),
        send_idx=t(send_idx_t.reshape(D * D, s_max)),
        recv_map=t(recv_map_t.reshape(D * D, s_max)),
        row_ptr=t(rp_t.reshape(-1)), mesh=mesh,
    )
