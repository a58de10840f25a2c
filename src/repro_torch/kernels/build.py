"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, then loaded with
``ctypes``.  The library's file name carries a hash of its source and of
the shared headers ``csrc/*.cuh``, so an edited source or header is
rebuilt.  Nothing here runs at import time, and a failed
build raises: there is no path around a kernel that does not build.
:func:`load` holds a lock over the first build and load of a library, so
threads that launch concurrently (the campaign's planning threads) build
it once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under the toolkit root
    (``CUDA_HOME``, by default ``/usr/local/cuda``).  Raises
    ``RuntimeError`` when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, content-addressed by the source,
    every shared header ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, *, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per kernel).  Returns the library.
    """
    out = library_path(name)
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, out)       # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process.
    The build runs under a lock: a concurrent first caller waits for it,
    then finds the library built."""
    with _LOAD_LOCK:
        return ctypes.CDLL(str(build(name)))
