"""Build libckaminpar_tpu_torch.so, the port's C ABI library (own copy of
kaminpar_tpu/native/build_capi.py).

Usage: python -m kaminpar_tpu_torch.native.build_capi [output_dir]

Compiles native/ckaminpar.cpp with ``g++`` against the running
interpreter's headers and libpython into ``_build/`` (or output_dir), so
that C and C++ programs can partition through include/ckaminpar_tpu.h:

    gcc prog.c -I include -L kaminpar_tpu_torch/_build \\
        -lckaminpar_tpu_torch -o prog
    PYTHONPATH=$PWD ./prog

The library embeds a Python interpreter that imports kaminpar_tpu_torch,
so the package must be on the program's PYTHONPATH.  It is rebuilt only
when its source or flags changed (a stamp beside it holds their hash).
The compile runs under the native build timeout
(KAMINPAR_TPU_NATIVE_BUILD_TIMEOUT); a failed or timed-out build raises
NativeUnavailable.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

LIB_NAME = "libckaminpar_tpu_torch.so"


def _command(src: Path, out: Path) -> list:
    include = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    version = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var(
        "VERSION"
    )
    return [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        str(src),
        f"-I{include}",
        f"-L{libdir}",
        f"-Wl,-rpath,{libdir}",
        f"-lpython{version}",
        "-o", str(out),
    ]


def build(out_dir: str | None = None) -> str:
    """Compile the library unless a current build exists; returns its
    path."""
    from . import BUILD_DIR, build_timeout
    from ..resilience.errors import NativeUnavailable

    src = Path(__file__).resolve().with_name("ckaminpar.cpp")
    out_path = Path(out_dir) if out_dir else BUILD_DIR
    out_path.mkdir(parents=True, exist_ok=True)
    out = out_path / LIB_NAME
    cmd = _command(src, out)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(cmd).encode()).hexdigest()
    stamp = out.with_name(LIB_NAME + ".sha256")
    if out.exists() and stamp.exists() and stamp.read_text() == digest:
        return str(out)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            _command(src, tmp), check=True, capture_output=True, text=True,
            timeout=build_timeout(),
        )
    except subprocess.TimeoutExpired as e:
        raise NativeUnavailable(
            f"C-ABI build timed out after {build_timeout():.0f}s "
            "(KAMINPAR_TPU_NATIVE_BUILD_TIMEOUT raises the limit)"
        ) from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(
            f"C-ABI build failed: {(e.stderr or '')[-400:]}") from e
    except OSError as e:
        raise NativeUnavailable(f"toolchain unavailable: {e}") from e
    os.replace(tmp, out)
    stamp.write_text(digest)
    return str(out)


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else None))
