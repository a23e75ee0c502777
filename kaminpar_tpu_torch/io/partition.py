"""Partition file IO (counterpart of kaminpar_tpu/io/partition.py;
include/kaminpar-io/kaminpar_io.h:37-54).

A partition file is one block id per line, node order = graph order.
Block-size files store one block weight per line.
"""

from __future__ import annotations

import numpy as np


def read_partition(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int32, ndmin=1)


def write_partition(path: str, partition: np.ndarray) -> None:
    np.savetxt(path, np.asarray(partition, dtype=np.int32), fmt="%d")


def write_block_sizes(path: str, partition: np.ndarray, k: int) -> None:
    sizes = np.bincount(np.asarray(partition), minlength=k)
    np.savetxt(path, sizes, fmt="%d")


def read_block_sizes(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64, ndmin=1)


def write_remapping(path: str, mapping: np.ndarray) -> None:
    """One new node id per line (kaminpar_io.h write_remapping analog;
    used to persist e.g. the degree-bucket permutation)."""
    np.savetxt(path, np.asarray(mapping, dtype=np.int64), fmt="%d")
