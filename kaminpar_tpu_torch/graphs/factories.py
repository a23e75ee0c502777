"""Programmatic graph factories (own copy of
kaminpar_tpu/graphs/factories.py).

The reference's test fixtures (tests/shm/graph_factories.h: make_grid_graph,
make_path, make_star, ...) and the synthetic generators standing in for
its KaGen inputs (kaminpar-io/dist_skagen.cc): RMAT, 2-D and 3-D random
geometric graphs, GNM, Barabasi-Albert, grids, a Delaunay triangulation
and a triangulated grid.  Each draws the JAX package's graph, bitwise,
for the same arguments; an omitted seed means seed 0.  `generate` builds
a graph from a KaGen-style option string (the CLI's ``gen:`` inputs), and
`parse_gen_spec` reads those strings for the streamed generators
(io/skagen.py) too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .host import HostGraph, from_edge_list


def make_empty_graph(n: int = 0) -> HostGraph:
    return HostGraph(np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))


def make_path(n: int, edge_weight: int = 1) -> HostGraph:
    if n <= 1:
        return make_empty_graph(n)
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    w = np.full(n - 1, edge_weight, dtype=np.int64)
    return from_edge_list(n, e, w)


def make_cycle(n: int) -> HostGraph:
    if n <= 2:
        return make_path(n)
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return from_edge_list(n, e)


def make_star(n_leaves: int) -> HostGraph:
    """Node 0 is the hub."""
    n = n_leaves + 1
    e = np.stack([np.zeros(n_leaves, dtype=np.int64), np.arange(1, n)], axis=1)
    return from_edge_list(n, e)


def make_grid_graph(rows: int, cols: int) -> HostGraph:
    """4-neighbor grid (tests/shm/graph_factories.h make_grid_graph)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return from_edge_list(rows * cols, np.concatenate([right, down]))


def make_complete_graph(n: int, edge_weight: int = 1) -> HostGraph:
    iu = np.triu_indices(n, k=1)
    e = np.stack(iu, axis=1)
    w = np.full(len(e), edge_weight, dtype=np.int64)
    return from_edge_list(n, e, w)


def make_complete_bipartite_graph(a: int, b: int) -> HostGraph:
    left = np.repeat(np.arange(a), b)
    right = a + np.tile(np.arange(b), a)
    return from_edge_list(a + b, np.stack([left, right], axis=1))


def make_isolated_graph(n: int) -> HostGraph:
    return make_empty_graph(n)


def make_matching_graph(num_pairs: int) -> HostGraph:
    e = np.stack(
        [2 * np.arange(num_pairs), 2 * np.arange(num_pairs) + 1], axis=1
    )
    return from_edge_list(2 * num_pairs, e)


# Shared generator parameters — single source of truth for both the
# in-process generators below and the streaming variants (io/skagen.py).
RMAT_DEFAULT_ABC = (0.57, 0.19, 0.19)


def rgg2d_radius(n: int, avg_degree: float) -> float:
    """Connection radius giving ~avg_degree expected neighbors on the
    unit square."""
    return float(np.sqrt(avg_degree / (np.pi * max(n, 1))))


def rgg3d_radius(n: int, avg_degree: float) -> float:
    """Connection radius giving ~avg_degree expected neighbors in the
    unit cube."""
    return float((avg_degree / (4.0 / 3.0 * np.pi * max(n, 1))) ** (1.0 / 3.0))


def make_delaunay(n: int, seed: Optional[int] = None) -> HostGraph:
    """Delaunay triangulation of n uniform random points on the unit
    square (the KaGen RDG2D analog) — the real-topology graph class the
    reference's quality claims are evaluated on (Walshaw/KaGen meshes)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed if seed is not None else 0)
    pts = rng.random((n, 2))
    tri = Delaunay(pts)
    s = tri.simplices
    e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    return from_edge_list(n, e.astype(np.int64))


def make_fe_grid(rows: int, cols: int) -> HostGraph:
    """Triangulated structured grid: each unit cell split into two
    triangles, so interior nodes have degree 6 — an fe_ocean-class
    finite-element mesh stand-in (planar, bounded degree, small
    separators) built deterministically without external mesh files."""
    ids = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    diag = np.stack([ids[:-1, :-1].ravel(), ids[1:, 1:].ravel()], axis=1)
    return from_edge_list(rows * cols, np.concatenate([right, down, diag]))


def make_rgg2d(
    n: int, avg_degree: float = 8.0, seed: Optional[int] = None
) -> HostGraph:
    """Random geometric graph on the unit square — the reference ships
    misc/rgg2d.metis as its sample workload; this generates comparable
    inputs of arbitrary size (stand-in for KaGen RGG2D)."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    pts = rng.random((n, 2))
    radius = rgg2d_radius(n, avg_degree)
    # cell-grid neighbor search
    ncell = max(1, int(1.0 / radius))
    cell = (pts * ncell).astype(np.int64).clip(0, ncell - 1)
    cell_id = cell[:, 0] * ncell + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    edges = []
    starts = np.searchsorted(cell_id[order], np.arange(ncell * ncell + 1))
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # compare each cell against neighbor cell (dx, dy)
            for cx in range(ncell):
                nx = cx + dx
                if not (0 <= nx < ncell):
                    continue
                for cy in range(ncell):
                    ny = cy + dy
                    if not (0 <= ny < ncell):
                        continue
                    a = order[starts[cx * ncell + cy] : starts[cx * ncell + cy + 1]]
                    b = order[starts[nx * ncell + ny] : starts[nx * ncell + ny + 1]]
                    if len(a) == 0 or len(b) == 0:
                        continue
                    d2 = ((pts[a, None, :] - pts[None, b, :]) ** 2).sum(-1)
                    ii, jj = np.nonzero(d2 <= radius * radius)
                    mask = a[ii] < b[jj]
                    if mask.any():
                        edges.append(np.stack([a[ii][mask], b[jj][mask]], axis=1))
    all_edges = (
        np.concatenate(edges) if edges else np.zeros((0, 2), dtype=np.int64)
    )
    return from_edge_list(n, all_edges)


def make_rmat(
    n: int,
    m: int,
    a: float = RMAT_DEFAULT_ABC[0],
    b: float = RMAT_DEFAULT_ABC[1],
    c: float = RMAT_DEFAULT_ABC[2],
    seed: Optional[int] = None,
) -> HostGraph:
    """RMAT generator (stand-in for KaGen RMAT; BASELINE.json's scale-22
    workload).  n must be a power of two."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    scale = int(np.log2(n))
    if 1 << scale != n:
        raise ValueError("rmat n must be a power of two")
    probs = np.array([a, b, c, 1.0 - a - b - c])
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        quad = rng.choice(4, size=m, p=probs)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    return from_edge_list(n, np.stack([src, dst], axis=1))


def make_rgg3d(
    n: int, avg_degree: float = 8.0, seed: Optional[int] = None
) -> HostGraph:
    """Random geometric graph on the unit cube (KaGen RGG3D stand-in,
    kaminpar-io/dist_skagen.cc generator lineage)."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    pts = rng.random((n, 3))
    radius = (avg_degree * 3.0 / (4.0 * np.pi * n)) ** (1.0 / 3.0)
    ncell = max(1, int(1.0 / radius))
    cell = (pts * ncell).astype(np.int64).clip(0, ncell - 1)
    cell_id = (cell[:, 0] * ncell + cell[:, 1]) * ncell + cell[:, 2]
    order = np.argsort(cell_id, kind="stable")
    starts = np.searchsorted(cell_id[order], np.arange(ncell**3 + 1))
    edges = []
    r2 = radius * radius
    for cid in range(ncell**3):
        a = order[starts[cid] : starts[cid + 1]]
        if len(a) == 0:
            continue
        cx, rem = divmod(cid, ncell * ncell)
        cy, cz = divmod(rem, ncell)
        for dx in (-1, 0, 1):
            nx = cx + dx
            if not (0 <= nx < ncell):
                continue
            for dy in (-1, 0, 1):
                ny = cy + dy
                if not (0 <= ny < ncell):
                    continue
                for dz in (-1, 0, 1):
                    nz = cz + dz
                    if not (0 <= nz < ncell):
                        continue
                    nid = (nx * ncell + ny) * ncell + nz
                    b = order[starts[nid] : starts[nid + 1]]
                    if len(b) == 0:
                        continue
                    d2 = ((pts[a, None, :] - pts[None, b, :]) ** 2).sum(-1)
                    ii, jj = np.nonzero(d2 <= r2)
                    mask = a[ii] < b[jj]
                    if mask.any():
                        edges.append(
                            np.stack([a[ii][mask], b[jj][mask]], axis=1)
                        )
    all_edges = (
        np.concatenate(edges) if edges else np.zeros((0, 2), dtype=np.int64)
    )
    return from_edge_list(n, all_edges)


def make_gnm(n: int, m: int, seed: Optional[int] = None) -> HostGraph:
    """Uniform random graph with ~m undirected edges (KaGen GNM_UNDIRECTED
    stand-in)."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    src = rng.integers(0, n, m, dtype=np.int64)
    dst = rng.integers(0, n, m, dtype=np.int64)
    keep = src != dst
    return from_edge_list(n, np.stack([src[keep], dst[keep]], axis=1))


def make_ba(n: int, d: int = 4, seed: Optional[int] = None) -> HostGraph:
    """Barabási–Albert preferential attachment (KaGen BA stand-in): each
    new node attaches to d targets sampled from the current edge list
    (the classic repeated-endpoint trick)."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    targets = np.zeros(2 * n * d, dtype=np.int64)
    edges = np.empty((n * d, 2), dtype=np.int64)
    cnt = 0
    for u in range(n):
        for j in range(d):
            if cnt == 0 or rng.random() < 0.5 or u == 0:
                t = int(rng.integers(0, max(u, 1)))
            else:
                t = int(targets[int(rng.integers(0, 2 * cnt))])
            edges[cnt] = (u, t)
            targets[2 * cnt] = u
            targets[2 * cnt + 1] = t
            cnt += 1
    e = edges[:cnt]
    e = e[e[:, 0] != e[:, 1]]
    return from_edge_list(n, e)


def make_grid3d(x: int, y: int, z: int) -> HostGraph:
    """3D grid graph (KaGen GRID_3D stand-in)."""
    idx = np.arange(x * y * z).reshape(x, y, z)
    edges = []
    edges.append(np.stack([idx[:-1].ravel(), idx[1:].ravel()], axis=1))
    edges.append(
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    )
    edges.append(
        np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], axis=1)
    )
    return from_edge_list(x * y * z, np.concatenate(edges))


_GENERATORS = {
    "rgg2d": make_rgg2d,
    "rgg3d": make_rgg3d,
    "rmat": make_rmat,
    "gnm": make_gnm,
    "ba": make_ba,
    "grid2d": lambda rows, cols: make_grid_graph(rows, cols),
    "grid3d": make_grid3d,
    "delaunay": make_delaunay,
    "fegrid": make_fe_grid,
}


def parse_gen_spec(spec: str) -> tuple:
    """Parse a KaGen-style option string (dKaMinPar's
    `-G "<type>;<key>=<value>;..."` surface, kaminpar-io/dist_skagen.h)
    into (name, kwargs) — shared by the in-process and streaming
    (io/skagen.py) generator paths."""
    parts = [p for p in spec.replace("gen:", "", 1).split(";") if p]
    name = parts[0]
    kwargs = {}
    for p in parts[1:]:
        key, _, value = p.partition("=")
        kwargs[key.strip()] = float(value) if "." in value else int(value)
    return name, kwargs


def generate(spec: str) -> HostGraph:
    """Build a synthetic graph from a KaGen-style option string: e.g.
    "rgg2d;n=1024;avg_degree=8", "rmat;n=65536;m=1000000;seed=1",
    "grid3d;x=8;y=8;z=8"."""
    name, kwargs = parse_gen_spec(spec)
    if name not in _GENERATORS:
        raise ValueError(
            f"unknown generator '{name}' (available: {sorted(_GENERATORS)})"
        )
    return _GENERATORS[name](**kwargs)
