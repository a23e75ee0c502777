"""Streamed synthetic graph generation — the KaGen-streaming analog (own
copy of kaminpar_tpu/io/skagen.py: the same chunks for the same spec).

The reference's dKaMinPar can consume a synthetic graph *streamed in
chunks* from the external KaGen library (kaminpar-io/dist_skagen.cc:
``read_or_generate_graph`` pulls per-PE streaming chunks so no process
ever materializes the global edge list).  This module is the
framework's native equivalent:

* every generator is **chunk-deterministic**: the assembled graph is
  bitwise identical for ANY number of chunks (the KaGen contract) —
  edge batches are derived from fixed-size counter blocks with
  per-block seeds, and RGG point sets come from a deterministic
  recursive binomial split over the cell grid, so any chunk can
  regenerate exactly the points/edges it needs without global state;
* a chunk yields the CSR rows of a contiguous vertex range with peak
  memory O(m / num_chunks + batch), trading regeneration work for
  memory exactly like KaGen's streaming mode;
* :func:`hostgraph_from_stream` assembles chunks into a
  :class:`HostGraph` without ever building the global directed edge
  list (the usual ``from_edge_list`` path allocates 2m edge triples
  before sorting; the streamed path peaks at one chunk).

Supported generator kinds mirror ``graphs/factories.py``'s in-process
surface where streaming is meaningful: ``rmat``, ``gnm`` (counter-block
edge regeneration) and ``rgg2d`` (cell-local point regeneration).
Preferential attachment (``ba``) is inherently sequential and has no
streaming form, in KaGen or here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from ..graphs.host import NODE_DTYPE, WEIGHT_DTYPE, HostGraph

# Fixed counter-block size: edge draws [i*B, (i+1)*B) always come from
# the block-i RNG regardless of chunking, which is what makes the
# output chunking-invariant.
EDGE_BLOCK = 1 << 18


def _block_rng(seed: int, tag: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=(0x5CA9E, seed & 0xFFFFFFFF, tag, index))
    )


@dataclass(frozen=True)
class GraphChunk:
    """CSR rows of the contiguous vertex range [v_begin, v_end)."""

    v_begin: int
    v_end: int
    xadj: np.ndarray  # int64[v_end - v_begin + 1], chunk-relative offsets
    adjncy: np.ndarray  # global neighbor ids
    adjwgt: np.ndarray  # merged multiplicities (parallel edges sum)


class StreamedGraph:
    """Lazy chunked view of a synthetic graph (one KaGen stream)."""

    def __init__(self, kind: str, n: int, num_chunks: int, seed: int,
                 params: dict):
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        self.kind = kind
        self.n = int(n)
        self.num_chunks = int(min(num_chunks, max(self.n, 1)))
        self.seed = int(seed)
        self.params = params
        self._cell_counts_cache: Optional[np.ndarray] = None

    # -- vertex ranges ----------------------------------------------------
    def chunk_range(self, c: int) -> Tuple[int, int]:
        base, rem = divmod(self.n, self.num_chunks)
        v0 = c * base + min(c, rem)
        return v0, v0 + base + (1 if c < rem else 0)

    # -- chunk materialization -------------------------------------------
    def chunk(self, c: int) -> GraphChunk:
        if not (0 <= c < self.num_chunks):
            raise IndexError(c)
        v0, v1 = self.chunk_range(c)
        if self.kind in ("rmat", "gnm"):
            src, dst = self._edge_chunk(v0, v1)
        elif self.kind in ("rgg2d", "rgg3d"):
            src, dst = self._rgg_chunk(v0, v1)
        else:  # pragma: no cover - guarded by streamed()
            raise ValueError(self.kind)
        return _rows_from_directed(v0, v1, self.n, src, dst)

    @property
    def _dim(self) -> int:
        return 3 if self.kind == "rgg3d" else 2

    def chunks(self) -> Iterator[GraphChunk]:
        for c in range(self.num_chunks):
            yield self.chunk(c)

    # -- counter-block edge generators (rmat / gnm) ----------------------
    def _edge_block(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Directed edge draws of counter block i.  Chunking invariance
        only needs block content to be a deterministic function of
        (seed, block index): every consumer computes the same cnt for
        block i, so the final partial block draws exactly cnt values."""
        m = int(self.params["m"])
        lo = i * EDGE_BLOCK
        cnt = min(EDGE_BLOCK, m - lo)
        rng = _block_rng(self.seed, 1, i)
        if self.kind == "rmat":
            scale = self.params["scale"]
            probs = self.params["probs"]
            u = np.zeros(cnt, dtype=np.int64)
            v = np.zeros(cnt, dtype=np.int64)
            for _ in range(scale):
                quad = rng.choice(4, size=cnt, p=probs)
                u = (u << 1) | (quad >> 1)
                v = (v << 1) | (quad & 1)
        else:  # gnm
            u = rng.integers(0, self.n, cnt, dtype=np.int64)
            v = rng.integers(0, self.n, cnt, dtype=np.int64)
        return u, v

    def _edge_chunk(self, v0: int, v1: int) -> Tuple[np.ndarray, np.ndarray]:
        """All directed edges with source in [v0, v1): both directions of
        every undirected draw are considered, self-loops dropped."""
        m = int(self.params["m"])
        nblocks = (m + EDGE_BLOCK - 1) // EDGE_BLOCK
        srcs, dsts = [], []
        for i in range(nblocks):
            u, v = self._edge_block(i)
            keep = u != v
            u, v = u[keep], v[keep]
            for a, b in ((u, v), (v, u)):
                sel = (a >= v0) & (a < v1)
                if sel.any():
                    srcs.append(a[sel])
                    dsts.append(b[sel])
        if not srcs:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        return np.concatenate(srcs), np.concatenate(dsts)

    # -- RGG2D/RGG3D: deterministic cell grid ----------------------------
    def _cell_counts(self) -> np.ndarray:
        """Points per cell via a deterministic recursive binomial split of
        n — depends only on (seed, n, ncell), so it is computed once per
        StreamedGraph and cached (O(#cells) memory; the per-PE equivalent
        of KaGen's distributed splitting)."""
        if self._cell_counts_cache is not None:
            return self._cell_counts_cache
        ncell = self.params["ncell"]
        total_cells = ncell ** self._dim
        counts = np.zeros(total_cells, dtype=np.int64)
        stack = [(0, total_cells, self.n)]
        while stack:
            lo, hi, cnt = stack.pop()
            if cnt == 0:
                continue
            if hi - lo == 1:
                counts[lo] = cnt
                continue
            mid = (lo + hi) // 2
            rng = _block_rng(self.seed, 2, lo * (total_cells + 1) + hi)
            left = int(rng.binomial(cnt, (mid - lo) / (hi - lo)))
            stack.append((lo, mid, left))
            stack.append((mid, hi, cnt - left))
        self._cell_counts_cache = counts
        return counts

    def _cell_coords(self, cell: int) -> Tuple[int, ...]:
        """Decode a flat cell id into grid coordinates (row-major: the 2D
        decode matches the original divmod(cell, ncell) layout)."""
        ncell = self.params["ncell"]
        coords = []
        for _ in range(self._dim):
            cell, c = divmod(cell, ncell)
            coords.append(c)
        return tuple(reversed(coords))

    def _cell_points(self, cell: int, count: int) -> np.ndarray:
        ncell = self.params["ncell"]
        rng = _block_rng(self.seed, 3, cell)
        pts = rng.random((count, self._dim))
        return (pts + np.array(self._cell_coords(cell))) / ncell

    def _neighbor_cells(self, cell: int):
        from itertools import product

        ncell = self.params["ncell"]
        coords = self._cell_coords(cell)
        for deltas in product((-1, 0, 1), repeat=self._dim):
            nb = [c + d for c, d in zip(coords, deltas)]
            if all(0 <= c < ncell for c in nb):
                flat = 0
                for c in nb:
                    flat = flat * ncell + c
                yield flat

    def _rgg_chunk(self, v0: int, v1: int) -> Tuple[np.ndarray, np.ndarray]:
        """Directed edges with source in [v0, v1).  Vertex ids are
        cell-major (prefix sums of the deterministic cell counts); only
        the cells overlapping the range plus their 3^dim-neighborhoods
        are regenerated."""
        radius = self.params["radius"]
        counts = self._cell_counts()
        starts = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        # owned cells: those whose vertex span intersects [v0, v1)
        own_cells = np.nonzero((starts[1:] > v0) & (starts[:-1] < v1))[0]
        if len(own_cells) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        # regenerate owned + neighbor cells once
        need = set()
        for cell in own_cells:
            need.update(self._neighbor_cells(int(cell)))
        pts = {c: self._cell_points(c, int(counts[c])) for c in sorted(need)}
        r2 = radius * radius
        srcs, dsts = [], []
        for cell in own_cells:
            a_pts = pts[int(cell)]
            if len(a_pts) == 0:
                continue
            a_ids = starts[cell] + np.arange(len(a_pts), dtype=np.int64)
            a_sel = (a_ids >= v0) & (a_ids < v1)
            if not a_sel.any():
                continue
            for b_cell in self._neighbor_cells(int(cell)):
                b_pts = pts[b_cell]
                if len(b_pts) == 0:
                    continue
                b_ids = starts[b_cell] + np.arange(
                    len(b_pts), dtype=np.int64
                )
                d2 = ((a_pts[:, None, :] - b_pts[None, :, :]) ** 2).sum(-1)
                ii, jj = np.nonzero(d2 <= r2)
                keep = a_sel[ii] & (a_ids[ii] != b_ids[jj])
                if keep.any():
                    srcs.append(a_ids[ii][keep])
                    dsts.append(b_ids[jj][keep])
        if not srcs:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        return np.concatenate(srcs), np.concatenate(dsts)


def _rows_from_directed(
    v0: int, v1: int, n: int, src: np.ndarray, dst: np.ndarray
) -> GraphChunk:
    """Sort + merge the chunk's directed edges into CSR rows (parallel
    edges merge by multiplicity sum — the from_edge_list convention)."""
    span = v1 - v0
    if len(src) == 0:
        return GraphChunk(
            v0, v1, np.zeros(span + 1, dtype=np.int64),
            np.zeros(0, dtype=NODE_DTYPE), np.zeros(0, dtype=WEIGHT_DTYPE),
        )
    # multiplier n (not a power-of-two constant): (span * n + dst) stays
    # within int64 up to n ~ 3e9, the same bound as from_edge_list's key
    key = (src - v0) * np.int64(n) + dst
    order = np.argsort(key, kind="stable")
    key, src, dst = key[order], src[order], dst[order]
    uniq = np.empty(len(key), dtype=bool)
    uniq[0] = True
    uniq[1:] = key[1:] != key[:-1]
    seg = np.cumsum(uniq) - 1
    wgt = np.bincount(seg, minlength=seg[-1] + 1).astype(WEIGHT_DTYPE)
    src_u, dst_u = src[uniq], dst[uniq]
    xadj = np.zeros(span + 1, dtype=np.int64)
    np.add.at(xadj, src_u - v0 + 1, 1)
    np.cumsum(xadj, out=xadj)
    return GraphChunk(v0, v1, xadj, dst_u.astype(NODE_DTYPE), wgt)


def streamed(spec: str, num_chunks: int = 8,
             seed: Optional[int] = None) -> StreamedGraph:
    """Build a streamed generator from a KaGen-style option string
    (the same surface as ``graphs.factories.generate``):
    ``"rmat;n=65536;m=1000000;seed=1"``, ``"gnm;n=4096;m=30000"``,
    ``"rgg2d;n=1024;avg_degree=8"``."""
    from ..graphs.factories import (
        RMAT_DEFAULT_ABC,
        parse_gen_spec,
        rgg2d_radius,
        rgg3d_radius,
    )

    kind, kw = parse_gen_spec(spec)
    if seed is None:
        seed = int(kw.pop("seed", 1))
    else:
        kw.pop("seed", None)
    n = int(kw.pop("n"))
    if kind == "rmat":
        scale = int(np.log2(n))
        if 1 << scale != n:
            raise ValueError("rmat n must be a power of two")
        a = kw.pop("a", RMAT_DEFAULT_ABC[0])
        b = kw.pop("b", RMAT_DEFAULT_ABC[1])
        cc = kw.pop("c", RMAT_DEFAULT_ABC[2])
        params = {
            "m": int(kw.pop("m")),
            "scale": scale,
            "probs": np.array([a, b, cc, 1.0 - a - b - cc]),
        }
    elif kind == "gnm":
        params = {"m": int(kw.pop("m"))}
    elif kind == "rgg2d":
        radius = rgg2d_radius(n, float(kw.pop("avg_degree", 8.0)))
        params = {"radius": radius, "ncell": max(1, int(1.0 / radius))}
    elif kind == "rgg3d":
        radius = rgg3d_radius(n, float(kw.pop("avg_degree", 8.0)))
        params = {"radius": radius, "ncell": max(1, int(1.0 / radius))}
    else:
        raise ValueError(
            f"generator '{kind}' has no streaming form "
            "(available: rmat, gnm, rgg2d, rgg3d)"
        )
    if kw:
        raise ValueError(f"unknown option(s) for {kind}: {sorted(kw)}")
    return StreamedGraph(kind, n, num_chunks, seed, params)


def hostgraph_from_stream(sg: StreamedGraph) -> HostGraph:
    """Assemble the stream into a HostGraph chunk by chunk.  Peak extra
    memory is one chunk plus the output CSR — the global 2m-triple edge
    list of the from_edge_list path is never built."""
    xadj = np.zeros(sg.n + 1, dtype=np.int64)
    adj_parts, wgt_parts = [], []
    for ch in sg.chunks():
        deg = ch.xadj[1:] - ch.xadj[:-1]
        xadj[ch.v_begin + 1 : ch.v_end + 1] = deg
        adj_parts.append(ch.adjncy)
        wgt_parts.append(ch.adjwgt)
    np.cumsum(xadj, out=xadj)
    adjncy = (
        np.concatenate(adj_parts) if adj_parts
        else np.zeros(0, dtype=NODE_DTYPE)
    )
    wgt = (
        np.concatenate(wgt_parts) if wgt_parts
        else np.zeros(0, dtype=WEIGHT_DTYPE)
    )
    unit = bool(len(wgt) == 0 or (wgt == 1).all())
    return HostGraph(
        xadj=xadj, adjncy=adjncy,
        edge_weights=None if unit else wgt,
    )
