"""Connected components on the device (counterpart of
kaminpar_tpu/ops/components.py).

Label contraction: every node starts with its own id; each round takes
the minimum label over the neighborhood (one segment_min over the COO
edge list) and then jumps pointers (label = label[label]) until they are
stable.  The JAX package runs both loops inside `lax.while_loop`; here
they are host loops that read one flag back per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import DeviceGraph
from .gather import gather_i32
from .segments import segment_min


def connected_components(graph: DeviceGraph) -> torch.Tensor:
    """i32[n_pad]: per node, the minimum node id in its component (pad
    slots keep their own id)."""
    n_pad = graph.n_pad
    labels = graph.node_ids()
    changed = True
    while changed:
        neigh_min = segment_min(gather_i32(labels, graph.dst), graph.src,
                                n_pad)
        new = torch.minimum(labels, neigh_min)
        # pointer jumping: adopt the label's label until stable
        jumping = True
        while jumping:
            jumped = gather_i32(new, new)
            jumping = bool((jumped != new).any())
            new = jumped
        changed = bool((new != labels).any())
        labels = new
    return labels


def count_components(graph: DeviceGraph) -> int:
    """Number of connected components among the real nodes."""
    labels = connected_components(graph)[: graph.n].cpu().numpy()
    return len(np.unique(labels)) if graph.n else 0
