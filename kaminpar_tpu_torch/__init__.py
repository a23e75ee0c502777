"""kaminpar_tpu_torch — the PyTorch/CUDA port of kaminpar_tpu.

A second package beside the JAX one, for one NVIDIA H100: plain tensor
code is PyTorch, and the two Pallas kernels of the JAX package are
hand-written CUDA kernels (csrc/, built with nvcc for sm_90a at first
use).  Every entry point takes ``device=`` and defaults to ``"cuda"``;
``device="cpu"`` runs the kernels' plain torch twins.  For the same input
and seed the partition is bitwise the JAX package's.

    g = load_graph("graph.metis")   # METIS, ParHiP or a compressed container
    part = KaMinPar("default").set_graph(g).compute_partition(k=16)
"""

__version__ = "0.1.0"

from .context import Context  # noqa: F401
from .graphs.factories import make_rgg2d, make_rmat  # noqa: F401
from .graphs.host import HostGraph  # noqa: F401
from .io import load_graph  # noqa: F401
from .kaminpar import KaMinPar, context_from_preset  # noqa: F401

__all__ = [
    "Context",
    "HostGraph",
    "KaMinPar",
    "context_from_preset",
    "load_graph",
    "make_rgg2d",
    "make_rmat",
]
