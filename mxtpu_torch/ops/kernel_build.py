"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

No counterpart in ``mxtpu/``: Pallas kernels are compiled by JAX itself.
Here each source under ``csrc/`` compiles into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), at
first use, from the checkout's own sources, into ``mxtpu_torch/_build/``
(listed in ``.gitignore``).  The library's name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is built once per
checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Tuple

from ..base import MXNetError

__all__ = ["CudaKernel", "nvcc_path", "build", "library_key"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's usual place."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME): the port's CUDA "
                     "kernels are built from source at first use")


def library_key(source: str) -> str:
    """Hash of ``csrc/<source>``, every ``csrc/*.cuh`` (in name order)
    and the flags: the part of the library's name that changes with
    what nvcc would compile."""
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` into ``_build/<stem>-<hash>.so`` unless
    that library exists.  Returns (library path, compiler output)."""
    src = CSRC / source
    lib = BUILD_DIR / ("%s-%s.so" % (src.stem, library_key(source)))
    if lib.exists():
        return lib, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed on %s (exit %d):\n%s%s"
                             % (source, proc.returncode, proc.stdout,
                                proc.stderr))
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


class CudaKernel(object):
    """One C entry point of one source, built and loaded at first call.

    ``launches`` counts the calls that launched the kernel: it rises by
    one where the C function returned success, and nowhere else.  The C
    function returns ``cudaGetLastError()`` after its launch; a non-zero
    value raises here (a refused launch never runs, and a later
    synchronize would not report it)."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def load(self):
        """Build (if needed) and bind the C function; idempotent."""
        with self._lock:
            if self._fn is None:
                lib, self.build_log = build(self.source)
                fn = getattr(ctypes.CDLL(str(lib)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise MXNetError("%s (%s): launch failed with CUDA error %d"
                             % (self.symbol, self.source, err))
        self.launches += 1
