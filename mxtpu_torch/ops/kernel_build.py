"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

No counterpart in ``mxtpu/``: Pallas kernels are compiled by JAX itself.
Here each source under ``csrc/`` compiles into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), at
first use, from the checkout's own sources, into ``mxtpu_torch/_build/``
(listed in ``.gitignore``).  The library's name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is built once per
checkout.  A kernel may also be built from another directory of sources
(a copy of ``csrc/`` with one line changed, or another checkout's), into
a build directory of the caller's choosing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Tuple

from ..base import MXNetError

__all__ = ["CudaKernel", "nvcc_path", "build", "library_key",
           "ptxas_summary"]

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


def library_key(source: str, csrc: Path = None) -> str:
    """Hash of ``<csrc>/<source>``, every ``<csrc>/*.cuh`` (in name
    order) and the flags: the part of the library's name that changes
    with what nvcc would compile.  ``csrc`` defaults to the package's."""
    csrc = CSRC if csrc is None else Path(csrc)
    text = (csrc / source).read_bytes()
    for header in sorted(csrc.glob("*.cuh")):
        text += header.read_bytes()
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]


def build(source: str, csrc: Path = None,
          build_dir: Path = None) -> Tuple[Path, str]:
    """Compile ``<csrc>/<source>`` into ``<build_dir>/<stem>-<hash>.so``
    unless that library exists (defaults: the package's ``csrc/`` and
    ``_build/``).  Returns (library path, compiler output)."""
    csrc = CSRC if csrc is None else Path(csrc)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    src = csrc / source
    lib = build_dir / ("%s-%s.so" % (src.stem, library_key(source, csrc)))
    if lib.exists():
        return lib, ""
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(build_dir))
    os.close(fd)
    cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed on %s (exit %d):\n%s%s"
                             % (src, proc.returncode, proc.stdout,
                                proc.stderr))
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def _kernel_name(mangled: str):
    """'path<args>' for a kernel ``<path>::kernel<...>`` of the port's
    sources, read from its mangled name ``_ZN<len><name>...6kernelI...E``
    (else None).  The namespace is the path: wg = the bf16 wgmma path,
    tc = mma.sync, f32 = the CUDA cores.  Template arguments: the head
    dim; then the backward's mode (dq or dkv) or the forward's sign of
    the scale (1 or -1)."""
    if not mangled.startswith("_ZN"):
        return None
    pos, names = 3, []
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + m.end()
        pos = start + int(m.group())
        names.append(mangled[start:pos])
    k = re.match(r"I((?:L[ib]n?\d+E)+)E", mangled[pos:])
    if len(names) < 2 or names[-1] != "kernel" or not k:
        return None
    args = []
    for kind, value in re.findall(r"L([ib])(n?\d+)E", k.group(1)):
        if kind == "b":
            args.append("dkv" if value == "1" else "dq")
        else:
            args.append(value.replace("n", "-"))
    return "%s<%s>" % (names[-2], ",".join(args))


def ptxas_summary(build_log: str) -> List[str]:
    """'path<D[,mode]> R regs, spill S' per kernel from the
    ``-Xptxas -v`` lines of a build, in the order ptxas reports them
    (see ``_kernel_name``); then every warning, and every note of a
    potential performance loss (such as wgmma serialised), as ptxas
    wrote it."""
    out, warnings, name, spill = [], [], None, "?"
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"'(_Z\w+)'", line)
            name = _kernel_name(m.group(1)) if m else None
        elif "warning" in line or "Performance Loss" in line:
            warnings.append(line.strip())
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append("%s %s regs, spill %s" % (name, regs, spill))
            name, spill = None, "?"
    return out + warnings


class CudaKernel(object):
    """One C entry point of one source, built and loaded at first call.

    ``launches`` counts the calls that launched the kernel: it rises by
    one where the C function returned success, and nowhere else.  The C
    function returns ``cudaGetLastError()`` after its launch; a non-zero
    value raises here (a refused launch never runs, and a later
    synchronize would not report it)."""

    def __init__(self, source: str, symbol: str, argtypes: List,
                 csrc: Path = None, build_dir: Path = None):
        self.source = source
        self.csrc, self.build_dir = csrc, build_dir
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
                lib, self.build_log = build(self.source, self.csrc,
                                             self.build_dir)
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
