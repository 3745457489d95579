"""Dependency engine of the PyTorch port: host work ordered by variables.

Counterpart of ``mxtpu/engine.py`` (with the ctypes signatures of
``mxtpu/_native.py``).  On the card CUDA streams order the device's
work; this engine orders the host's (input pipelines, decode, writes).
A pushed function names the variables it reads (``const_vars``) and
writes (``mutable_vars``): writes to a variable run one at a time in
push order, reads of it run together between them.  Two engines behind
one API, chosen by ``MXTPU_ENGINE_TYPE`` (or ``MXNET_ENGINE_TYPE``):

* ``ThreadedEngine`` (the default): the versioned-variable scheduler of
  ``src/engine.cc``, whose worker threads call the Python functions
  (ctypes takes the GIL for each call).  The port builds that source,
  read-only, with the host's C++ compiler (``$CXX``, else ``g++`` or
  ``c++``) into ``mxtpu_torch/_build/engine-<hash>.so`` at first use;
  the hash covers the source, its header and the flags, and the library
  is written under a temporary name and renamed, so processes that
  build at once never load half a file.  A failed build raises with the
  compiler's output: there is no quiet fall-back to the naive engine.
* ``NaiveEngine``: each function runs at its push, on the caller's
  thread, for deterministic debugging.

An exception raised by a pushed function is kept on its mutable
variables and raised (as ``MXNetError``) by ``wait_for_var``.
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
from typing import Callable, Dict, Optional, Sequence

from .base import MXNetError

__all__ = ["Engine", "NaiveEngine", "ThreadedEngine", "get_engine",
           "set_engine", "build", "library_path"]

SRC_DIR = Path(__file__).resolve().parents[1] / "src"
SOURCES = ("engine.cc", "include/mxtpu_runtime.h")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

AsyncFnType = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise MXNetError("no C++ compiler found (set CXX): the threaded "
                     "engine is built from src/engine.cc at first use")


def library_path(build_dir: Path = None) -> Path:
    """Where the engine's library lives once built (in ``build_dir``,
    by default ``mxtpu_torch/_build/``): its name carries a hash of the
    sources and the flags."""
    text = b"".join((SRC_DIR / s).read_bytes() for s in SOURCES)
    key = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()) \
        .hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / ("engine-%s.so" % key)


def build(build_dir: Path = None) -> Path:
    """Compile ``src/engine.cc`` into ``library_path(build_dir)`` unless
    that library exists; returns its path."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(lib.parent))
    os.close(fd)
    cmd = [_cxx()] + CXX_FLAGS + ["-I", str(SRC_DIR), "-o", tmp,
                                  str(SRC_DIR / "engine.cc")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("building the engine failed (exit %d): "
                             "%s\n%s%s" % (proc.returncode, " ".join(cmd),
                                           proc.stdout, proc.stderr))
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def get_lib() -> ctypes.CDLL:
    """The engine's library, built at the first call."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.MXTPUGetLastError.restype = ctypes.c_char_p
            lib.MXTPUEngineCreate.restype = ctypes.c_void_p
            lib.MXTPUEngineCreate.argtypes = [ctypes.c_int]
            lib.MXTPUEngineFree.argtypes = [ctypes.c_void_p]
            lib.MXTPUEngineNewVar.restype = ctypes.c_uint64
            lib.MXTPUEngineNewVar.argtypes = [ctypes.c_void_p]
            lib.MXTPUEnginePushAsync.restype = ctypes.c_int
            lib.MXTPUEnginePushAsync.argtypes = [
                ctypes.c_void_p, AsyncFnType, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
            lib.MXTPUEngineWaitForVar.restype = ctypes.c_int
            lib.MXTPUEngineWaitForVar.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_uint64]
            lib.MXTPUEngineWaitForAll.argtypes = [ctypes.c_void_p]
            lib.MXTPUEngineVarVersion.restype = ctypes.c_uint64
            lib.MXTPUEngineVarVersion.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_uint64]
            lib.MXTPUEngineNumOutstanding.restype = ctypes.c_int64
            lib.MXTPUEngineNumOutstanding.argtypes = [ctypes.c_void_p]
            lib.MXTPUEngineDeleteVar.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_uint64]
            _LIB = lib
        return _LIB


class Var(object):
    __slots__ = ("handle", "_engine")

    def __init__(self, handle, engine):
        self.handle = handle
        self._engine = engine

    @property
    def version(self):
        """The number of writes to this variable that have finished."""
        return self._engine.var_version(self)


class Engine(object):
    """The engine's API."""

    def new_var(self) -> Var:
        raise NotImplementedError

    def push(self, fn: Callable[[], None], const_vars: Sequence[Var] = (),
             mutable_vars: Sequence[Var] = (), priority: int = 0):
        raise NotImplementedError

    def wait_for_var(self, var: Var):
        raise NotImplementedError

    def wait_for_all(self):
        raise NotImplementedError

    def var_version(self, var: Var) -> int:
        raise NotImplementedError

    def delete_var(self, var: Var):
        pass


class NaiveEngine(Engine):
    """Runs each function at its push.  An exception raises at the push
    and is also kept for ``wait_for_var``."""

    def __init__(self):
        self._versions: Dict[int, int] = {}
        self._errors: Dict[int, BaseException] = {}
        self._next = 1

    def new_var(self) -> Var:
        v = Var(self._next, self)
        self._next += 1
        self._versions[v.handle] = 0
        return v

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        try:
            fn()
        except BaseException as e:
            for v in mutable_vars:
                self._errors[v.handle] = e
            raise
        finally:
            for v in mutable_vars:
                self._versions[v.handle] = \
                    self._versions.get(v.handle, 0) + 1

    def wait_for_var(self, var: Var):
        err = self._errors.pop(var.handle, None)
        if err is not None:
            raise MXNetError(str(err)) from err

    def wait_for_all(self):
        pass

    def var_version(self, var: Var) -> int:
        return self._versions.get(var.handle, 0)


class ThreadedEngine(Engine):
    """The scheduler of ``src/engine.cc`` with ``num_threads`` workers
    (``MXTPU_CPU_WORKER_NTHREADS``/``MXNET_CPU_WORKER_NTHREADS``, 4 by
    default).  ``close`` waits for every pushed function and joins the
    workers."""

    def __init__(self, num_threads: Optional[int] = None):
        lib = get_lib()
        if num_threads is None:
            num_threads = int(os.environ.get(
                "MXTPU_CPU_WORKER_NTHREADS",
                os.environ.get("MXNET_CPU_WORKER_NTHREADS", "4")))
        self._lib = lib
        self._h = ctypes.c_void_p(lib.MXTPUEngineCreate(num_threads))
        self._cb_lock = threading.Lock()
        self._callbacks: Dict[int, tuple] = {}  # alive until they ran
        self._errors: Dict[int, BaseException] = {}  # var handle -> error
        self._next_cb = 1

        @AsyncFnType
        def trampoline(param):
            key = int(param)
            with self._cb_lock:
                fn, mvars = self._callbacks.pop(key)
            try:
                fn()
                return 0
            except Exception as e:  # raised again at the wait
                with self._cb_lock:
                    for vh in mvars:
                        self._errors[vh] = e
                return -1

        self._trampoline = trampoline

    def close(self):
        """Wait for every pushed function, then stop and join the
        workers; the engine takes no push after this."""
        if getattr(self, "_h", None):
            self._lib.MXTPUEngineFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _handle(self):
        if not self._h:
            raise MXNetError("the engine is closed")
        return self._h

    def new_var(self) -> Var:
        return Var(self._lib.MXTPUEngineNewVar(self._handle()), self)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        h = self._handle()
        with self._cb_lock:
            key = self._next_cb
            self._next_cb += 1
            self._callbacks[key] = (fn, [v.handle for v in mutable_vars])
        cvars = (ctypes.c_uint64 * max(1, len(const_vars)))(
            *[v.handle for v in const_vars])
        mvars = (ctypes.c_uint64 * max(1, len(mutable_vars)))(
            *[v.handle for v in mutable_vars])
        rc = self._lib.MXTPUEnginePushAsync(
            h, self._trampoline, ctypes.c_void_p(key),
            cvars, len(const_vars), mvars, len(mutable_vars), priority)
        if rc != 0:
            raise MXNetError("PushAsync failed: %s"
                             % self._lib.MXTPUGetLastError().decode())

    def wait_for_var(self, var: Var):
        rc = self._lib.MXTPUEngineWaitForVar(self._handle(), var.handle)
        with self._cb_lock:
            err = self._errors.pop(var.handle, None)
        if rc != 0 or err is not None:
            raise MXNetError("async op failed: %s"
                             % (err if err is not None else rc)) from err

    def wait_for_all(self):
        self._lib.MXTPUEngineWaitForAll(self._handle())

    def var_version(self, var: Var) -> int:
        return int(self._lib.MXTPUEngineVarVersion(self._handle(),
                                                   var.handle))

    def delete_var(self, var: Var):
        self._lib.MXTPUEngineDeleteVar(self._handle(), var.handle)

    def num_outstanding(self) -> int:
        """Functions pushed and not yet finished."""
        return int(self._lib.MXTPUEngineNumOutstanding(self._handle()))


_engine: Optional[Engine] = None
_engine_lock = threading.Lock()


def get_engine() -> Engine:
    """The process's engine, made at the first call:
    ``MXTPU_ENGINE_TYPE`` (or ``MXNET_ENGINE_TYPE``) ``NaiveEngine``
    gives the naive one, anything else the threaded one."""
    global _engine
    with _engine_lock:
        if _engine is None:
            kind = os.environ.get("MXTPU_ENGINE_TYPE",
                                  os.environ.get("MXNET_ENGINE_TYPE", ""))
            _engine = NaiveEngine() if kind == "NaiveEngine" \
                else ThreadedEngine()
        return _engine


def set_engine(engine: Optional[Engine]):
    """Make ``engine`` the process's engine (None: the next
    ``get_engine`` makes one anew)."""
    global _engine
    with _engine_lock:
        _engine = engine
