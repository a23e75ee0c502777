"""The generators on CPU torch at n <= 2^14: seeded and deterministic, simple
undirected graphs, and their statistics against the sources' formulas."""

import math

import numpy as np
import pytest
import torch

from portbench import cells, csr, graph

RMAT = dict(cells.config("rmat-g500"), scale=12)
RGG = dict(cells.config("rgg2d-dimacs"), log2_n=12)


def simple_undirected(xadj, adjncy):
    n = len(xadj) - 1
    src = np.repeat(np.arange(n), np.diff(xadj))
    assert xadj[0] == 0 and xadj[-1] == len(adjncy)
    assert (np.diff(xadj) >= 0).all()
    assert not (src == adjncy).any()
    key = src * n + adjncy
    assert (np.diff(key) > 0).all()  # rows sorted, no duplicates
    assert np.array_equal(np.sort(adjncy.astype(np.int64) * n + src), key)


@pytest.mark.parametrize("config", [RMAT, RGG], ids=["rmat", "rgg"])
def test_same_seed_same_graph(config):
    a = graph.make(config, 2**31 + 5, "cpu")
    b = graph.make(config, 2**31 + 5, "cpu")
    c = graph.make(config, 2**31 + 6, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert a[0].dtype == np.int64 and a[1].dtype == np.int32
    simple_undirected(*a)


def test_pairs_to_csr_drops_loops_and_duplicates():
    src = torch.tensor([0, 1, 1, 2, 3, 3])
    dst = torch.tensor([1, 0, 2, 2, 0, 0])
    xadj, adjncy = csr.to_host(*csr.pairs_to_csr(4, src, dst))
    assert xadj.tolist() == [0, 2, 4, 5, 6]
    assert adjncy.tolist() == [1, 3, 0, 2, 1, 0]


def test_kronecker_bits_follow_the_initiator():
    """Row bit 1 with probability C + D; column bit 1 with probability
    D / (C + D) after a row bit of 1 and B / (A + B) after a 0."""
    gen = cells.generator("kronecker")
    params = dict(RMAT, scale=14)
    row, col = gen.draw_pairs(
        params, torch.Generator().manual_seed(11), "cpu")
    a, b, c, d = params["initiator"]
    assert len(row) == params["edgefactor"] << 14
    bits = torch.arange(14)
    rb = ((row[:, None] >> bits) & 1).bool()
    cb = ((col[:, None] >> bits) & 1).bool()
    samples = rb.numel()
    tol = 4 / math.sqrt(samples)
    assert abs(rb.float().mean().item() - (c + d)) < tol
    assert abs(cb[rb].float().mean().item() - d / (c + d)) < 4 * tol
    assert abs(cb[~rb].float().mean().item() - b / (a + b)) < 2 * tol


def test_kronecker_seed_draws_the_graph():
    """One seed gives one graph; another seed draws other pairs."""
    a = graph.make(RMAT, 1, "cpu")
    b = graph.make(RMAT, 2, "cpu")
    again = graph.make(RMAT, 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, again))
    assert not np.array_equal(np.sort(np.diff(a[0])), np.sort(np.diff(b[0])))


def test_kronecker_edge_count():
    xadj, adjncy = graph.make(dict(RMAT, scale=14), 3, "cpu")
    pairs = RMAT["edgefactor"] << 14
    # duplicates and self-loops dropped: at most the pairs, most of them kept
    assert 0.75 * pairs < len(adjncy) // 2 <= pairs
    assert len(xadj) == (1 << 14) + 1


def test_rgg_joins_exactly_the_pairs_within_the_radius():
    params = dict(RGG, log2_n=10)
    n = 1 << 10
    gen = cells.generator("rgg2d")
    r = gen.radius(params)
    assert r == pytest.approx(0.55 * math.sqrt(math.log(n) / n))
    _, src, dst = gen.generate(params, 9, "cpu")
    got = set(zip(src.tolist(), dst.tolist()))
    # the same draw, the points in cell order, compared all against all
    g = torch.Generator().manual_seed(9)
    pts = torch.rand(n, 2, generator=g, dtype=torch.float64)
    cells_per_side = int(1.0 / r)
    cxy = (pts * cells_per_side).to(torch.int64).clamp(0, cells_per_side - 1)
    order = torch.sort(cxy[:, 0] * cells_per_side + cxy[:, 1], stable=True).indices
    p = pts[order].numpy()
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    i, j = np.nonzero(np.triu(d2 <= r * r, k=1))
    assert got == set(zip(i.tolist(), j.tolist()))


def test_rgg_mean_degree_matches_the_formula():
    """Expected degree of uniform points in the unit square, with the
    border's loss: (n - 1) (pi r^2 - 8/3 r^3 + r^4 / 2)."""
    params = dict(RGG, log2_n=14)
    n = 1 << 14
    r = cells.generator("rgg2d").radius(params)
    xadj, adjncy = graph.make(params, 4, "cpu")
    expected = (n - 1) * (math.pi * r * r - 8 / 3 * r ** 3 + r ** 4 / 2)
    assert len(adjncy) / n == pytest.approx(expected, rel=0.03)
