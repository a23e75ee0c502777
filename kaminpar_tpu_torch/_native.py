"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside
this file; the libraries are loaded with ctypes.  A library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
build is never loaded.  Nothing is built or loaded when this module is
imported: the CPU tests import every module and have no ``nvcc``.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("gather.cu", "dense_ratings.cu", "best_from_slots.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}

# a dict here makes every kernel launch record a pair of CUDA events under
# its kernel's name (chip_smoke.py sums them per cell); None records nothing
EVENT_LOG: Optional[Dict[str, List[tuple]]] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(sources=SOURCES) -> Dict[str, float]:
    """Compile every listed source that has no current build, one nvcc
    process per source, all started together.  Returns the seconds each
    compile took (0.0 for a source that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {src: 0.0 for src in sources}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    failures = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built first if needed)."""
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build((source,))
        lib = ctypes.CDLL(str(path))
        _LIBS[source] = lib
    return lib


def bind(source: str, symbol: str, argtypes,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of `source`, typed once and cached (a
    launch pays no lookup)."""
    fn = _FUNCS.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[(source, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


@contextmanager
def timed(name: str):
    """Record CUDA events around one launch when EVENT_LOG is set."""
    log = EVENT_LOG
    if log is None:
        yield
        return
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    log.setdefault(name, []).append((start, end))
