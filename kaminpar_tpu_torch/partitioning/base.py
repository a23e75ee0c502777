"""What the multilevel schemes (deep, k-way, RB, v-cycle) share: the
context and device, the wall time per phase (`timings`, seconds; a nested
phase is also counted in its parent), the (n, m) of every level of the
hierarchy, input first (`levels`), and the host <-> device hand-over of
partitions and block weights."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..context import Context
from ..dtypes import WMAX


class MultilevelScheme:
    def __init__(self, ctx: Context, device: torch.device):
        self.ctx = ctx
        self.device = device
        self.timings: Dict[str, float] = {}
        self.levels: List[Tuple[int, int]] = []

    @contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = (
                self.timings.get(name, 0.0) + time.perf_counter() - t0
            )

    def _pad_partition(self, part: np.ndarray, n_pad: int) -> torch.Tensor:
        padded = np.zeros(n_pad, dtype=np.int32)
        padded[: len(part)] = part
        return torch.from_numpy(padded).to(self.device)

    def _weights(self, weights: Optional[np.ndarray]):
        """Block weights as an int32 device tensor, clipped to WMAX."""
        if weights is None:
            return None
        return torch.as_tensor(
            np.minimum(weights, WMAX).astype(np.int32), device=self.device
        )

    def _final_block_weights(self):
        """(max, min) caps of the input's k blocks on the device."""
        p = self.ctx.partition
        return self._weights(p.max_block_weights), self._weights(
            p.min_block_weights
        )
