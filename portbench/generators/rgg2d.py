"""Random geometric graphs on the unit square, in torch on the device.

The 10th DIMACS Implementation Challenge's `rgg_n_2_<s>_s0` graphs:
n = 2^s points drawn uniformly from the unit square, two points joined
when their distance is at most r = radius_factor * sqrt(ln n / n)
(radius_factor 0.55).  The points are bucketed into square cells of side
at least r; each point is compared with the points of its own cell and
the eight around it, one neighbouring offset at a time so that the
candidate pairs of one offset are all that is held.  Nodes are numbered in
the order of their cell (row-major), points of one cell in draw order.
Coordinates are float64, as the challenge's generator used doubles.
"""

from __future__ import annotations

import math

import torch


def radius(params: dict) -> float:
    n = 1 << int(params["log2_n"])
    return float(params["radius_factor"]) * math.sqrt(math.log(n) / n)


def generate(params: dict, seed: int, device):
    """(n, src, dst): every pair within the radius once, src < dst."""
    n = 1 << int(params["log2_n"])
    r = radius(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pts = torch.rand(n, 2, generator=gen, device=device, dtype=torch.float64)
    cells = max(1, int(1.0 / r))
    cxy = (pts * cells).to(torch.int64).clamp_(0, cells - 1)
    cell = cxy[:, 0] * cells + cxy[:, 1]
    order = torch.sort(cell, stable=True).indices
    pts, cxy, cell = pts[order], cxy[order], cell[order]
    del order
    starts = torch.searchsorted(
        cell, torch.arange(cells * cells + 1, device=device))
    node = torch.arange(n, device=device)
    r2 = r * r
    srcs, dsts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx = cxy[:, 0] + dx
            ny = cxy[:, 1] + dy
            inside = (nx >= 0) & (nx < cells) & (ny >= 0) & (ny < cells)
            other = (nx * cells + ny).clamp_(0, cells * cells - 1)
            lo = starts[other]
            count = torch.where(inside, starts[other + 1] - lo, 0)
            src = torch.repeat_interleave(node, count)
            first = torch.cumsum(count, 0) - count
            dst = (torch.arange(src.numel(), device=device)
                   - torch.repeat_interleave(first - lo, count))
            d2 = ((pts[src] - pts[dst]) ** 2).sum(1)
            keep = (d2 <= r2) & (src < dst)
            srcs.append(src[keep])
            dsts.append(dst[keep])
            del src, dst, d2, keep, first, count, lo, other
    return n, torch.cat(srcs), torch.cat(dsts)
