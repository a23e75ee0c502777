"""The Graph500 Kronecker generator, in torch on the device.

Follows the specification's reference code (graph500.org, "Graph
Generation", kronecker_generator): M = edgefactor * 2^scale pairs, each
drawn bit by bit from the initiator (A, B, C, D = 1 - A - B - C): at every
level the row bit is 1 with probability C + D, and the column bit is 1 with
probability D / (C + D) after a row bit of 1 and B / (A + B) after a 0.
The vertex labels are then permuted at random.  Kernel 1 turns the pairs
into an undirected graph; here self-loops and duplicate edges are dropped
and every edge has weight 1.

The pairs and the label permutation are both drawn from the run's seed,
with one generator on the device.
"""

from __future__ import annotations

import torch


def draw_pairs(params: dict, gen: torch.Generator, device):
    """The M (row, column) pairs before the label permutation."""
    scale = int(params["scale"])
    a, b, c = (float(x) for x in params["initiator"][:3])
    m = int(params["edgefactor"]) << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    row = torch.zeros(m, dtype=torch.int64, device=device)
    col = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        row_bit = torch.rand(m, generator=gen, device=device) > ab
        col_cut = torch.where(row_bit, c_norm, a_norm)
        col_bit = torch.rand(m, generator=gen, device=device) > col_cut
        row |= row_bit.to(torch.int64) << bit
        col |= col_bit.to(torch.int64) << bit
    return row, col


def generate(params: dict, seed: int, device):
    """(n, src, dst): the pairs, then the labels permuted, from `seed`."""
    n = 1 << int(params["scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    row, col = draw_pairs(params, gen, device)
    perm = torch.randperm(n, generator=gen, device=device)
    return n, perm[row], perm[col]
