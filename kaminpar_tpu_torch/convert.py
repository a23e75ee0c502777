"""Graph, partition and configuration state handed over as plain values.

The system has no weights; what crosses between the JAX package and this
one is graph and partition state and the context.  With these functions a
caller hands both packages the same padded level (for example a coarse
level the JAX coarsener produced, read out with ``np.asarray``) and
compares the next step:

    dg = device_graph_from_arrays(row_ptr, src, dst, edge_w, node_w, n, m,
                                  device="cpu")
    labels = labels_from_numpy(np.asarray(jax_labels), device="cpu")

The arrays must already follow the padded layout of ``graphs/csr.py``
(pad edges at n_pad - 1 with weight 0, node pad weight 0).

``context_from_dict`` builds this package's Context from the nested dict
of plain values that the JAX package's ``context_to_dict`` gives, so that
both packages can be configured from one source.  A warm-start partition
is a numpy array and crosses as it is.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict

import numpy as np
import torch

from .context import Context, RefinementAlgorithm

from .device import DeviceLike, resolve_device
from .graphs.csr import device_graph_from_arrays  # noqa: F401  (re-export)

_INT32 = np.iinfo(np.int32)


def labels_from_numpy(
    labels: np.ndarray, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """An int32 label (or partition) vector on `device`, copied from any
    numpy integer array; raises when a value does not fit in int32."""
    arr = np.asarray(labels)
    if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError("labels must be a 1-D integer array")
    if arr.size and (arr.min() < _INT32.min or arr.max() > _INT32.max):
        raise ValueError("label values do not fit in int32")
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.int32)
    ).to(resolve_device(device))


def context_from_dict(data: Dict[str, Any]) -> Context:
    """This package's Context from a nested dict of plain values (enums as
    their values, arrays as lists, infinity as "inf"); fields the dict
    leaves out keep their defaults.  Raises ValueError on a field this
    package's Context lacks."""
    ctx = Context()
    _apply(ctx, data, "")
    return ctx


def _apply(node: Any, data: Dict[str, Any], path: str) -> None:
    for key, value in data.items():
        where = f"{path}{key}"
        if not (dataclasses.is_dataclass(node) and any(
                f.name == key for f in dataclasses.fields(node))):
            raise ValueError(f"the port's Context has no field {where!r}")
        current = getattr(node, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ValueError(f"{where!r} must be a table")
            _apply(current, value, where + ".")
        elif isinstance(current, enum.Enum):
            setattr(node, key, type(current)(value))
        elif key == "algorithms":
            setattr(node, key, [RefinementAlgorithm(v) for v in value])
        elif isinstance(current, list):
            setattr(node, key, list(value))
        elif isinstance(value, list):  # the block weight arrays
            setattr(node, key, np.asarray(value, dtype=np.int64))
        elif value == "inf":
            setattr(node, key, float("inf"))
        elif current is None or value is None:
            setattr(node, key, value)
        else:
            setattr(node, key, type(current)(value))
