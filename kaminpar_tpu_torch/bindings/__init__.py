"""Adapters to other graph frameworks (own copy of
kaminpar_tpu/bindings/).

The reference ships pybind11 Python bindings and a NetworKit Cython
module (bindings/python, bindings/networkit).  This package is Python,
so its Python binding is the package itself (kaminpar_tpu_torch.KaMinPar);
this subpackage holds:

  * networkit: a NetworKit graph -> HostGraph adapter with the reference
    binding's call surface (kaminpar_networkit.cc analog), on the card
    unless asked for the CPU;
  * the C ABI lives in native/ckaminpar.cpp and include/ckaminpar_tpu.h.
"""

from .networkit import NetworKitKaMinPar  # noqa: F401
