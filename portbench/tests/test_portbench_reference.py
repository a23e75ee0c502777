"""The reference on hand-made graphs whose cuts and block weights are known."""

import numpy as np
import pytest

from portbench.reference import partition as ref


def csr(n, edges):
    """Both directions of each undirected edge, rows sorted."""
    e = np.asarray(edges)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((dst, src))
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    return np.cumsum(xadj), dst[order].astype(np.int32)


PATH4 = csr(4, [(0, 1), (1, 2), (2, 3)])
CYCLE6 = csr(6, [(i, (i + 1) % 6) for i in range(6)])


@pytest.mark.parametrize("part, cut, weights", [
    ([0, 0, 1, 1], 1, [2, 2]),
    ([0, 1, 0, 1], 3, [2, 2]),
    ([0, 0, 0, 0], 0, [4, 0]),
])
def test_path(part, cut, weights):
    xadj, adjncy = PATH4
    got = ref.recount(xadj, adjncy, np.array(part), 2)
    assert got["cut"] == cut and got["total_edge_weight"] == 3
    assert got["block_weights"].tolist() == weights
    assert got["out_of_range"] == 0


def test_cycle_in_three_blocks():
    xadj, adjncy = CYCLE6
    got = ref.recount(xadj, adjncy, np.array([0, 0, 1, 1, 2, 2]), 3)
    assert got["cut"] == 3 and got["block_weights"].tolist() == [2, 2, 2]


def test_blocks_of_rows_give_the_same_cut(monkeypatch):
    rng = np.random.default_rng(1)
    n = 300
    edges = {tuple(sorted(p)) for p in rng.integers(0, n, (2000, 2))
             if p[0] != p[1]}
    xadj, adjncy = csr(n, sorted(edges))
    part = rng.integers(0, 4, n)
    whole = ref.recount(xadj, adjncy, part, 4)
    monkeypatch.setattr(ref, "BLOCK_EDGES", 7)
    assert ref.recount(xadj, adjncy, part, 4)["cut"] == whole["cut"]
    src = np.repeat(np.arange(n), np.diff(xadj))
    assert whole["cut"] == np.count_nonzero(part[src] != part[adjncy]) // 2


def test_out_of_range_and_wrong_length():
    xadj, adjncy = PATH4
    assert ref.recount(xadj, adjncy, np.array([0, 2, -1, 1]), 2)[
        "out_of_range"] == 2
    short = ref.recount(xadj, adjncy, np.array([0, 1]), 2)
    assert short["out_of_range"] == 4 and short["cut"] is None


def test_cap_and_judge():
    # (1 + 0.03) * ceil(4194304 / 16) = 270008.32
    assert ref.block_cap(1 << 22, 16, 0.03) == 270008
    assert ref.block_cap(1 << 22, 256, 0.03) == 16875
    xadj, adjncy = PATH4
    counted = ref.recount(xadj, adjncy, np.array([0, 0, 0, 1]), 2)
    v = ref.judge(counted, 2, 0.03, 4, reported_cut=3)
    assert v["overload"] == 3 - 2 and v["cut_gap"] == 2
    assert v["cut"] == 1 and v["cut_frac"] == pytest.approx(1 / 3)
    assert ref.judge(counted, 2, 0.5, 4, None)["overload"] == 0
