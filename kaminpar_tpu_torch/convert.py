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
is a numpy array and crosses as it is.  ``dist_graph_from_arrays`` builds
a sharded graph (parallel/dist_graph.py) from the JAX package's
DistGraph fields.
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


def dist_graph_from_arrays(fields: dict, mesh: Mesh) -> DistGraph:
    """A DistGraph from the JAX package's field arrays (as numpy: src,
    dst, edge_w, node_w, n, m, dst_local, ghost_gid, send_idx,
    recv_map) on `mesh`, so that both packages can be handed one shard
    layout; row_ptr is recovered from the shards' real edges (every real
    edge precedes the pads, and no real edge ends at the pad node)."""
    from .parallel.dist_graph import DistGraph

    D = mesh.size
    a = {k: np.asarray(v) for k, v in fields.items()}
    n_pad = a["node_w"].shape[0]
    n_loc, m_loc = n_pad // D, a["src"].shape[0] // D
    src_t = a["src"].reshape(D, m_loc)
    dst_t = a["dst"].reshape(D, m_loc)
    rp_t = np.zeros((D, n_loc + 1), dtype=np.int32)
    for d in range(D):
        c = int((dst_t[d] != n_pad - 1).sum())
        deg = np.bincount(src_t[d, :c] - d * n_loc, minlength=n_loc)
        rp_t[d, 1:] = np.cumsum(deg[:n_loc])
    dev = mesh.device

    def t(name):
        return torch.from_numpy(
            np.ascontiguousarray(a[name].astype(np.int32))).to(dev)

    return DistGraph(
        src=t("src"), dst=t("dst"), edge_w=t("edge_w"), node_w=t("node_w"),
        n=int(a["n"]), m=int(a["m"]), dst_local=t("dst_local"),
        ghost_gid=t("ghost_gid"), send_idx=t("send_idx"),
        recv_map=t("recv_map"),
        row_ptr=torch.from_numpy(rp_t.reshape(-1)).to(dev), mesh=mesh,
    )
