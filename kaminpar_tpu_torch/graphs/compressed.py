"""Compressed host graph (TeraPart analog; counterpart of
kaminpar_tpu/graphs/compressed.py, with the same streams byte for byte).

The reference's memory-frugal mode stores neighborhoods gap+varint
encoded, with interval encoding for consecutive runs and a StreamVByte
batch codec (kaminpar-common/graph_compression/compressed_neighborhoods.h,
datastructures/compressed_graph.h), so tera-scale graphs fit in RAM.  The
device graph stays flat int32 CSR, so compression lives on the host: a
`CompressedHostGraph` holds the encoded streams (native/codec.cpp and
codec2.cpp) and decodes node ranges on demand — chunk by chunk for the
device upload (graphs/csr.device_graph_from_compressed), per node for
host algorithms.

Two codecs:
  * "gap" — varint gap streams (codec.cpp; numpy twin without g++);
  * "v2"  — interval encoding + StreamVByte-class packed residuals +
            varint edge weights (codec2.cpp; native only), the default
            when the codec library is built or buildable.  Edge weights
            are stored compressed in the v2 emit order (interval members
            first), so decoded adjacency and weights pair 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import native
from .host import HostGraph


@dataclass
class CompressedHostGraph:
    """Compressed CSR (CompressedGraph analog)."""

    xadj: np.ndarray  # i64[n+1] degrees prefix (uncompressed, like reference)
    offsets: np.ndarray  # i64[n+1] byte offset per node's stream
    data: np.ndarray  # u8[total] encoded neighborhoods
    node_weights: Optional[np.ndarray] = None
    edge_weights: Optional[np.ndarray] = None  # raw (gap codec only)
    codec: str = "gap"  # "gap" (codec.cpp) or "v2" (codec2.cpp)
    wdata: Optional[np.ndarray] = None  # u8: varint weights (v2 only)
    woffsets: Optional[np.ndarray] = None  # i64[n+1] (v2 only)

    def __post_init__(self):
        if (
            self.codec == "v2"
            and self.edge_weights is not None
            and self.wdata is None
        ):
            # v2 decodes adjacency in EMIT order (interval members first),
            # so weights must come from the v2 weight stream (wdata),
            # which is written in the same order; a raw input-order
            # edge_weights array would silently misalign
            raise ValueError(
                "v2-codec graphs must carry edge weights as wdata "
                "(emit-order compressed stream), not raw edge_weights"
            )

    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def m(self) -> int:
        return int(self.xadj[-1])

    def degrees(self) -> np.ndarray:
        return self.xadj[1:] - self.xadj[:-1]

    def neighbors(self, u: int) -> np.ndarray:
        """Decode one node (compressed_graph.h adjacent_nodes analog)."""
        if self.codec == "v2":
            return native.decode_v2_node(u, self.xadj, self.offsets, self.data)
        return native.decode_node(u, self.xadj, self.offsets, self.data)

    def decode_range(self, v0: int, v1: int):
        """Decode the rows of node range [v0, v1) only — the decoders
        index their byte streams through absolute per-node offsets, so a
        slice of (rebased xadj, offsets) decodes independently.  Returns
        (xadj_rel i64[v1-v0+1], adjncy, edge_weights|None); peak memory
        is the range's plain rows, which is what lets the chunked device
        upload and the external scheme stream node ranges."""
        if not (0 <= v0 <= v1 <= self.n):
            raise IndexError((v0, v1))
        xadj_rel = self.xadj[v0 : v1 + 1] - self.xadj[v0]
        offs = self.offsets[v0 : v1 + 1]
        if self.codec == "v2":
            adjncy = native.decode_v2(xadj_rel, offs, self.data)
            # __post_init__ guarantees v2 never carries raw edge_weights
            ew = None
            if self.wdata is not None:
                ew = native.decode_v2_weights(
                    xadj_rel, self.woffsets[v0 : v1 + 1], self.wdata
                )
        else:
            adjncy = native.decode_gaps(xadj_rel, offs, self.data)
            ew = (
                None
                if self.edge_weights is None
                else self.edge_weights[self.xadj[v0] : self.xadj[v1]]
            )
        return xadj_rel, adjncy, ew

    def decode(self) -> HostGraph:
        """Materialize the full CSR graph."""
        if self.codec == "v2":
            adjncy = native.decode_v2(self.xadj, self.offsets, self.data)
            ew = self.edge_weights
            if self.wdata is not None:
                ew = native.decode_v2_weights(
                    self.xadj, self.woffsets, self.wdata
                )
        else:
            adjncy = native.decode_gaps(self.xadj, self.offsets, self.data)
            ew = self.edge_weights
        return HostGraph(
            xadj=self.xadj.copy(),
            adjncy=adjncy,
            node_weights=self.node_weights,
            edge_weights=ew,
        )

    def node_weight_array(self) -> np.ndarray:
        if self.node_weights is not None:
            return np.asarray(self.node_weights, dtype=np.int64)
        return np.ones(self.n, dtype=np.int64)

    @property
    def total_node_weight(self) -> int:
        return int(self.node_weight_array().sum())

    @property
    def total_edge_weight(self) -> int:
        """Sum of edge weights without decoding the adjacency (the
        weight stream alone is decoded when weights are compressed) —
        lets PartitionContext.setup run on a still-compressed graph."""
        if self.wdata is not None:
            w = native.decode_v2_weights(self.xadj, self.woffsets, self.wdata)
            return int(w.sum())
        if self.edge_weights is not None:
            return int(np.asarray(self.edge_weights, dtype=np.int64).sum())
        return self.m

    def memory_bytes(self) -> int:
        total = self.xadj.nbytes + self.offsets.nbytes + self.data.nbytes
        if self.node_weights is not None:
            total += self.node_weights.nbytes
        if self.edge_weights is not None:
            total += self.edge_weights.nbytes
        if self.wdata is not None:
            total += self.wdata.nbytes + self.woffsets.nbytes
        return total

    def compression_ratio(self) -> float:
        """Uncompressed adjacency(+weight) bytes / compressed stream bytes
        (the reference reports the same ratio in its compression stats)."""
        raw = self.m * 4
        enc = self.data.nbytes
        if self.wdata is not None:
            raw += self.m * 4
            enc += self.wdata.nbytes
        return raw / max(1, enc)


def compress_host_graph(
    graph: HostGraph, codec: str = "auto"
) -> CompressedHostGraph:
    """Build the compressed form (compressed_graph_builder.h analog).

    Neighborhoods must be sorted ascending for gap/interval coding; the
    builder sorts per node when needed (the reference's builder requires
    the same and offers reorder_edges_by_compression, permutator.h:241).
    `codec`: "v2" (TeraPart parity, native only), "gap", or "auto" (v2
    when the codec library is built or buildable)."""
    adjncy = graph.adjncy
    xadj = np.asarray(graph.xadj, dtype=np.int64)
    # ensure sorted neighborhoods (cheap check first)
    needs_sort = False
    if graph.m:
        d = np.diff(adjncy.astype(np.int64))
        row_start = np.zeros(graph.m, dtype=bool)
        row_start[xadj[:-1][graph.degrees() > 0]] = True
        needs_sort = bool((d < 0)[~row_start[1:]].any())
    ew = graph.edge_weights
    if needs_sort:
        src = graph.edge_sources()
        order = np.lexsort((adjncy, src))
        adjncy = adjncy[order]
        if ew is not None:
            ew = np.asarray(ew)[order]
    if codec == "auto":
        codec = "v2" if native.codec_enabled() else "gap"
    if codec == "v2":
        data, offsets = native.encode_v2(xadj, adjncy)
        wdata = woffsets = None
        if ew is not None:
            wdata, woffsets = native.encode_v2_weights(xadj, adjncy, ew)
        return CompressedHostGraph(
            xadj=xadj,
            offsets=offsets,
            data=data,
            node_weights=graph.node_weights,
            edge_weights=None,
            codec="v2",
            wdata=wdata,
            woffsets=woffsets,
        )
    data, offsets = native.encode_gaps(xadj, adjncy)
    return CompressedHostGraph(
        xadj=xadj,
        offsets=offsets,
        data=data,
        node_weights=graph.node_weights,
        edge_weights=ew,
        codec="gap",
    )


def compressed_partition_metrics(
    cgraph: CompressedHostGraph,
    partition,
    k: int,
    chunk_nodes: int = 1 << 18,
) -> dict:
    """host_partition_metrics without decoding the full CSR: the cut is
    accumulated over decoded node-range chunks (decode_range), so peak
    host memory stays at compressed + one chunk + O(n).  Definitions
    match graphs.host.host_partition_metrics exactly (same RESULT line
    semantics)."""
    partition = np.asarray(partition)
    n = cgraph.n
    cut = 0
    for v0 in range(0, n, chunk_nodes):
        v1 = min(n, v0 + chunk_nodes)
        xr, adj, ew = cgraph.decode_range(v0, v1)
        deg = np.diff(np.asarray(xr, dtype=np.int64))
        src = np.repeat(np.arange(v0, v1, dtype=np.int64), deg)
        mask = partition[src] != partition[adj]
        cut += int(
            mask.sum() if ew is None else np.asarray(ew)[mask].sum()
        )
    nw = cgraph.node_weight_array()
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, partition, nw)
    perfect = max(1, -(-int(nw.sum()) // max(k, 1)))
    return {
        "cut": cut // 2,
        "block_weights": bw,
        "imbalance": bw.max() / perfect - 1.0 if k else 0.0,
    }


def compress_from_stream(sg, codec: str = "auto") -> CompressedHostGraph:
    """Compress a streamed graph (io/skagen.StreamedGraph) chunk by chunk
    — the full flat CSR never exists on the host (the reference's
    builder likewise ingests neighborhoods incrementally,
    compressed_graph_builder.h).  Peak memory: compressed streams + one
    decoded chunk + O(n).

    The per-node byte offsets of both codecs are absolute, so per-chunk
    encodings concatenate by rebasing each chunk's offsets by the bytes
    already written (decode_range depends on exactly this independence).
    """
    if codec == "auto":
        codec = "v2" if native.codec_enabled() else "gap"
    n = sg.n
    xadj = np.zeros(n + 1, dtype=np.int64)
    data_parts, off_parts = [], []
    wdata_parts, woff_parts = [], []
    byte_base = 0
    wbyte_base = 0
    any_weights = False
    for ch in sg.chunks():
        xr = np.asarray(ch.xadj, dtype=np.int64)
        adj = np.asarray(ch.adjncy, dtype=np.int32)
        xadj[ch.v_begin + 1 : ch.v_end + 1] = xr[1:] - xr[:-1]
        if codec == "v2":
            data_c, off_c = native.encode_v2(xr, adj)
        else:
            data_c, off_c = native.encode_gaps(xr, adj)
        data_parts.append(data_c)
        off_parts.append(np.asarray(off_c, dtype=np.int64)[:-1] + byte_base)
        byte_base += int(np.asarray(off_c)[-1])
        w = np.asarray(ch.adjwgt)
        if len(w) and not (w == 1).all():
            any_weights = True
        if codec == "v2":
            wd, wo = native.encode_v2_weights(xr, adj, w)
            wdata_parts.append(wd)
            woff_parts.append(
                np.asarray(wo, dtype=np.int64)[:-1] + wbyte_base
            )
            wbyte_base += int(np.asarray(wo)[-1])
        else:
            wdata_parts.append(w)
    np.cumsum(xadj, out=xadj)
    data = (
        np.concatenate(data_parts) if data_parts
        else np.zeros(0, dtype=np.uint8)
    )
    offsets = np.concatenate(
        (off_parts if off_parts else [np.zeros(0, np.int64)])
        + [np.asarray([byte_base], dtype=np.int64)]
    )
    if codec == "v2":
        if any_weights:
            wdata = np.concatenate(wdata_parts)
            woffsets = np.concatenate(
                woff_parts + [np.asarray([wbyte_base], dtype=np.int64)]
            )
        else:
            wdata = woffsets = None
        return CompressedHostGraph(
            xadj=xadj, offsets=offsets, data=data, codec="v2",
            wdata=wdata, woffsets=woffsets,
        )
    ew = np.concatenate(wdata_parts) if wdata_parts else None
    if ew is not None and (len(ew) == 0 or (ew == 1).all()):
        ew = None
    return CompressedHostGraph(
        xadj=xadj, offsets=offsets, data=data, codec="gap",
        edge_weights=ew,
    )


def extract_core_compressed(
    cgraph: CompressedHostGraph, chunk_nodes: int = 1 << 18
):
    """Compressed-to-compressed isolated-node extraction
    (kaminpar.cc:392-404 without ever materializing the flat CSR).

    Streams decoded node-range chunks, drops degree-0 rows, remaps
    neighbor ids through the monotone core numbering, re-sorts each row
    (v2 decodes in emit order; the encoders need ascending rows) and
    re-encodes — peak memory stays at compressed + one chunk + O(n).

    Returns (core CompressedHostGraph, core_ids, iso_ids): source node
    ids of the core (in order — the core numbering is their rank) and of
    the isolated nodes."""
    deg = cgraph.degrees()
    iso = deg == 0
    core_ids = np.flatnonzero(~iso)
    iso_ids = np.flatnonzero(iso)
    n_core = len(core_ids)
    new_id = (np.cumsum(~iso) - 1).astype(np.int64)

    class _CoreStream:
        n = n_core

        def chunks(self):
            from ..io.skagen import GraphChunk

            for v0 in range(0, cgraph.n, chunk_nodes):
                v1 = min(cgraph.n, v0 + chunk_nodes)
                keep = ~iso[v0:v1]
                if not keep.any():
                    continue
                xr, adj, ew = cgraph.decode_range(v0, v1)
                xr = np.asarray(xr, dtype=np.int64)
                dslice = np.diff(xr)
                adj2 = new_id[np.asarray(adj, dtype=np.int64)]
                row = np.repeat(np.arange(v1 - v0), dslice)
                order = np.lexsort((adj2, row))
                adj2 = adj2[order].astype(np.int32)
                w = (
                    np.ones(len(adj2), dtype=np.int64)
                    if ew is None
                    else np.asarray(ew, dtype=np.int64)[order]
                )
                # xadj of the kept rows only (isolated rows are empty, so
                # the edge stream is untouched by dropping them)
                kept_deg = dslice[keep]
                cxadj = np.concatenate(
                    [[0], np.cumsum(kept_deg)]
                ).astype(np.int64)
                first_core = int(new_id[v0 + int(np.argmax(keep))])
                yield GraphChunk(
                    v_begin=first_core,
                    v_end=first_core + int(keep.sum()),
                    xadj=cxadj,
                    adjncy=adj2,
                    adjwgt=w,
                )

    core = compress_from_stream(_CoreStream(), codec=cgraph.codec)
    if cgraph.node_weights is not None:
        core.node_weights = np.asarray(cgraph.node_weights)[core_ids]
    return core, core_ids, iso_ids
