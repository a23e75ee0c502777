"""A configuration's graph, drawn on the card from the run's seed and handed
to the caller as the host CSR that users give the partitioner."""

from __future__ import annotations

import torch

from . import cells
from .csr import pairs_to_csr, to_host


def make(config: dict, seed: int, device):
    """(xadj int64, adjncy int32) numpy arrays of the configuration's graph;
    nothing of it stays on the device."""
    n, src, dst = cells.generator(config["generator"]).generate(
        config, seed, device)
    xadj, adjncy = pairs_to_csr(n, src, dst)
    del src, dst
    host = to_host(xadj, adjncy)
    del xadj, adjncy
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return host
