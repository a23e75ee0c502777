"""Synthetic graph generators: RMAT and 2-D random geometric graphs,
standing in for the reference's KaGen inputs (kaminpar-io/dist_skagen.cc).

Own copy of the two generators of kaminpar_tpu/graphs/factories.py: they
draw the same graphs for the same seed.  An omitted seed means seed 0.
`parse_gen_spec` reads the KaGen-style option strings that the streamed
generators (io/skagen.py) take.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .host import HostGraph, from_edge_list


RMAT_DEFAULT_ABC = (0.57, 0.19, 0.19)


def rgg2d_radius(n: int, avg_degree: float) -> float:
    """Connection radius giving ~avg_degree expected neighbors on the
    unit square."""
    return float(np.sqrt(avg_degree / (np.pi * max(n, 1))))


def rgg3d_radius(n: int, avg_degree: float) -> float:
    """Connection radius giving ~avg_degree expected neighbors in the
    unit cube."""
    return float((avg_degree / (4.0 / 3.0 * np.pi * max(n, 1))) ** (1.0 / 3.0))


def parse_gen_spec(spec: str) -> tuple:
    """A KaGen-style option string (``"rmat;n=65536;m=1000000;seed=1"``,
    an optional ``gen:`` prefix) as (name, kwargs): a value with a dot
    is a float, any other an int."""
    parts = [p for p in spec.replace("gen:", "", 1).split(";") if p]
    name = parts[0]
    kwargs = {}
    for p in parts[1:]:
        key, _, value = p.partition("=")
        kwargs[key.strip()] = float(value) if "." in value else int(value)
    return name, kwargs


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
