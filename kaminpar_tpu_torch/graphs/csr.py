"""Device-resident padded CSR graph (counterpart of kaminpar_tpu/graphs/csr.py).

The same padded CSR + COO layout as the JAX package, held as torch tensors
on one device:

  * node pad slots: weight 0, degree 0 (row_ptr clamped to m);
  * edge pad slots: src = dst = n_pad - 1 (a guaranteed-pad node), weight 0.

With that convention most kernels need no explicit masks.  The upload
always pads n to at least n + 1, so slot n_pad - 1 is never a real node.

Unlike the JAX package, the true counts `n` and `m` are host ints: eager
torch has no traced scalars, and every consumer reads them on the host.
The shape floors are (256, 256) on every device: the JAX package raises
them off-CPU only to bound TPU compile time, which eager torch does not
pay, and equal floors keep n_pad (and with it the rating-engine choice and
the label bit widths) identical on the CPU and the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..caching import pad_size
from ..device import DeviceLike, resolve_device
from ..dtypes import NODE_DTYPE
from .host import HostGraph

SHAPE_FLOORS = (256, 256)


@dataclass
class DeviceGraph:
    """Padded CSR + COO graph on one device.

    row_ptr : i32[n_pad + 1]  CSR offsets; row_ptr[i] = m for i >= n
    src     : i32[m_pad]      COO edge sources (pad: n_pad - 1)
    dst     : i32[m_pad]      COO edge targets == CSR adjncy (pad: n_pad - 1)
    edge_w  : i32[m_pad]      edge weights (pad: 0)
    node_w  : i32[n_pad]      node weights (pad: 0)
    n, m    : host ints       true counts
    """

    row_ptr: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    edge_w: torch.Tensor
    node_w: torch.Tensor
    n: int
    m: int

    @property
    def n_pad(self) -> int:
        return self.node_w.shape[0]

    @property
    def m_pad(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_w.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def node_ids(self) -> torch.Tensor:
        return torch.arange(self.n_pad, dtype=NODE_DTYPE, device=self.device)

    def edge_mask(self) -> torch.Tensor:
        return (
            torch.arange(self.m_pad, dtype=NODE_DTYPE, device=self.device)
            < self.m
        )


def shape_floors() -> tuple[int, int]:
    """(n_floor, m_floor) shape-bucket floors for device graphs."""
    return SHAPE_FLOORS


def _device_graph(row_ptr, src, dst, edge_w, node_w, n, m,
                  device: DeviceLike) -> DeviceGraph:
    """Wrap padded int32 host arrays the caller owns and does not reuse."""
    dev = resolve_device(device)
    row_ptr, src, dst, edge_w, node_w = (
        torch.from_numpy(a).to(dev) for a in (row_ptr, src, dst, edge_w,
                                              node_w)
    )
    return DeviceGraph(row_ptr, src, dst, edge_w, node_w, int(n), int(m))


def device_graph_from_arrays(
    row_ptr: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    edge_w: np.ndarray,
    node_w: np.ndarray,
    n: int,
    m: int,
    device: DeviceLike = "cuda",
) -> DeviceGraph:
    """A DeviceGraph from already-padded host arrays (copied, so the
    graph never aliases a caller's or a read-only buffer)."""
    return _device_graph(
        *(np.array(a, dtype=np.int32)
          for a in (row_ptr, src, dst, edge_w, node_w)),
        n, m, device,
    )


def device_graph_from_host(
    graph: HostGraph,
    device: DeviceLike = "cuda",
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
) -> DeviceGraph:
    """Upload a HostGraph into the padded device layout."""
    n, m = graph.n, graph.m
    n_floor, m_floor = shape_floors()
    n_pad = n_pad if n_pad is not None else pad_size(n + 1, n_floor)
    m_pad = m_pad if m_pad is not None else pad_size(max(m, 1), m_floor)
    if n_pad < n + 1 or m_pad < m:
        raise ValueError("pad sizes too small")

    row_ptr = np.full(n_pad + 1, m, dtype=np.int32)
    row_ptr[: n + 1] = graph.xadj.astype(np.int32)
    pad_node = n_pad - 1
    src = np.full(m_pad, pad_node, dtype=np.int32)
    dst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_w = np.zeros(m_pad, dtype=np.int32)
    src[:m] = graph.edge_sources()
    dst[:m] = graph.adjncy
    edge_w[:m] = graph.edge_weight_array().astype(np.int32)
    node_w = np.zeros(n_pad, dtype=np.int32)
    node_w[:n] = graph.node_weight_array().astype(np.int32)
    return _device_graph(row_ptr, src, dst, edge_w, node_w, n, m, device)


class PinnedStaging:
    """Double-buffered pinned host staging for chunked uploads.

    `copy_into(outs, arrays)` copies each numpy array into a page-locked
    host buffer and from there into the matching device tensor with a
    non-blocking copy, so the host goes on decoding the next chunk while
    the copy runs.  Two buffer sets take turns, each with a CUDA event
    recorded after its copies: before a set is refilled the host waits
    on its event, since refilling a page-locked buffer whose copy is
    still in flight would corrupt the chunk being copied.  On the CPU
    the arrays are copied directly."""

    def __init__(self, device: torch.device, capacity: int, num_arrays: int):
        self.device = device
        self._cuda = device.type == "cuda"
        self._bufs: List[List[torch.Tensor]] = []
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0
        if self._cuda:
            self._bufs = [
                [torch.empty(max(int(capacity), 1), dtype=torch.int32,
                             pin_memory=True) for _ in range(num_arrays)]
                for _ in range(2)
            ]

    def copy_into(self, outs: Sequence[torch.Tensor],
                  arrays: Sequence[np.ndarray]) -> None:
        if not self._cuda:
            for out, arr in zip(outs, arrays):
                out.copy_(torch.from_numpy(np.ascontiguousarray(
                    arr, dtype=np.int32)))
            return
        b = self._turn
        self._turn ^= 1
        if self._events[b] is not None:
            self._events[b].synchronize()
        for out, arr, buf in zip(outs, arrays, self._bufs[b]):
            n = len(arr)
            buf.numpy()[:n] = arr
            out.copy_(buf[:n], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._events[b] = event

    def stage(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Fresh device tensors holding `arrays` (int32)."""
        outs = [torch.empty(len(a), dtype=torch.int32, device=self.device)
                for a in arrays]
        self.copy_into(outs, arrays)
        return outs


def device_graph_from_compressed(
    cgraph,
    device: DeviceLike = "cuda",
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    chunk_nodes: int = 1 << 18,
) -> DeviceGraph:
    """Upload a CompressedHostGraph into the padded device layout without
    ever building the flat CSR on the host: node-range chunks are decoded
    (`decode_range`), staged through pinned buffers and copied into
    their slices of the device edge arrays, whose pad tail is filled on
    the device.  Peak host memory is the compressed streams + one chunk
    + O(n).  The result equals `device_graph_from_host(cgraph.decode())`
    bitwise (JAX package: graphs/csr.py device_graph_from_compressed)."""
    dev = resolve_device(device)
    n, m = cgraph.n, cgraph.m
    n_floor, m_floor = shape_floors()
    n_pad = n_pad if n_pad is not None else pad_size(n + 1, n_floor)
    m_pad = m_pad if m_pad is not None else pad_size(max(m, 1), m_floor)
    if n_pad < n + 1 or m_pad < m:
        raise ValueError("pad sizes too small")
    pad_node = n_pad - 1

    # the O(n) arrays come straight from the (uncompressed) offsets
    xadj = np.asarray(cgraph.xadj, dtype=np.int64)
    row_ptr = np.full(n_pad + 1, m, dtype=np.int32)
    row_ptr[: n + 1] = xadj.astype(np.int32)
    node_w = np.zeros(n_pad, dtype=np.int32)
    node_w[:n] = cgraph.node_weight_array().astype(np.int32)

    src = torch.full((m_pad,), pad_node, dtype=torch.int32, device=dev)
    dst = torch.full((m_pad,), pad_node, dtype=torch.int32, device=dev)
    edge_w = torch.zeros(m_pad, dtype=torch.int32, device=dev)
    starts = list(range(0, n, chunk_nodes))
    max_edges = max((int(xadj[min(n, v0 + chunk_nodes)] - xadj[v0])
                     for v0 in starts), default=0)
    staging = PinnedStaging(dev, max_edges, 3)
    for v0 in starts:
        v1 = min(n, v0 + chunk_nodes)
        e0, e1 = int(xadj[v0]), int(xadj[v1])
        xr, adj, ew = cgraph.decode_range(v0, v1)
        src_c = np.repeat(np.arange(v0, v1, dtype=np.int32),
                          np.diff(np.asarray(xr, dtype=np.int64)))
        outs = [src[e0:e1], dst[e0:e1]]
        arrays = [src_c, np.asarray(adj, dtype=np.int32)]
        if ew is None:
            edge_w[e0:e1] = 1
        else:
            outs.append(edge_w[e0:e1])
            arrays.append(np.asarray(ew).astype(np.int32))
        staging.copy_into(outs, arrays)
        del xr, adj, ew, src_c  # keep the host high-water at one chunk
    return DeviceGraph(
        torch.from_numpy(row_ptr).to(dev), src, dst, edge_w,
        torch.from_numpy(node_w).to(dev), int(n), int(m),
    )


def host_graph_from_device(graph: DeviceGraph) -> HostGraph:
    """Download a DeviceGraph back into a compact HostGraph."""
    n, m = graph.n, graph.m
    xadj = graph.row_ptr[: n + 1].cpu().numpy().astype(np.int64)
    adjncy = graph.dst[:m].cpu().numpy().astype(np.int32)
    edge_w = graph.edge_w[:m].cpu().numpy().astype(np.int64)
    node_w = graph.node_w[:n].cpu().numpy().astype(np.int64)
    return HostGraph(
        xadj=xadj,
        adjncy=adjncy,
        node_weights=None if (node_w == 1).all() else node_w,
        edge_weights=None if m == 0 or (edge_w == 1).all() else edge_w,
    )
