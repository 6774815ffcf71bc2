"""Native host ops: C++ sources built with ``g++`` into shared libraries,
loaded with ``ctypes`` — counterpart of ``deepspeed_tpu/ops/op_builder.py``
(``OpBuilder``, ``AsyncIOBuilder``, ``HostAdamBuilder``, ``op_report``;
the reference's ``op_builder/builder.py:117`` ``OpBuilder``).

Each op declares its sources (under ``deepspeed_tpu_torch/csrc/``) and is
built at its first ``load()``, with JAX's flags (``-O3 -shared -fPIC
-std=c++17 -pthread -march=native -fopenmp``), into
``csrc/build/<hash of sources and flags>/lib<name>.so`` beside the CUDA
libraries (``ops/kernels``).  Nothing is built at import.

Unlike JAX's builder, which degrades when the toolchain is missing, a
missing ``g++`` or a failed build raises ``RuntimeError`` with the
compiler's output: the host ops have no other path.  A build that fails
with ``-march=native`` is retried once without it, as JAX retries; the
retry is the same build, never a switch to Python.  ``is_compatible()``
and ``op_report()`` report what is missing without raising.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-march=native", "-fopenmp"]

_LIBS: Dict[str, ctypes.CDLL] = {}  # library path -> loaded, bound library
_LOCK = threading.Lock()


class OpBuilder:
    """One native op: C++ sources -> one library loaded with ``ctypes``.
    ``src_root`` / ``build_root`` default to the package's ``csrc`` and its
    build directory."""

    NAME = "base"
    SOURCES: List[str] = []  # relative to src_root

    def __init__(self, src_root: str = CSRC, build_root: str = BUILD_ROOT):
        self.src_root = src_root
        self.build_root = build_root

    def absolute_sources(self) -> List[str]:
        return [os.path.join(self.src_root, s) for s in self.SOURCES]

    def sources_exist(self) -> bool:
        return all(os.path.exists(p) for p in self.absolute_sources())

    def is_compatible(self) -> bool:
        """``g++`` is on the PATH and the sources are present."""
        return shutil.which("g++") is not None and self.sources_exist()

    def _signature(self, flags: List[str]) -> str:
        h = hashlib.sha256(" ".join(flags).encode())
        for src in self.absolute_sources():
            with open(src, "rb") as fh:
                h.update(fh.read())
        return h.hexdigest()[:16]

    def so_path(self, flags: Optional[List[str]] = None) -> str:
        return os.path.join(self.build_root, self._signature(flags or FLAGS),
                            f"lib{self.NAME}.so")

    def _compile(self, flags: List[str]) -> Optional[str]:
        """Build with ``flags``; None on success, else the compiler's log."""
        out = self.so_path(flags)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *flags, "-o", tmp, *self.absolute_sources()]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            return f"$ {' '.join(cmd)}\n{proc.stdout}"
        os.replace(tmp, out)
        return None

    def build(self) -> str:
        """The library's path, compiled first if it is missing; raises
        ``RuntimeError`` with the compiler's output when it cannot be."""
        for flags in (FLAGS, [f for f in FLAGS if f != "-march=native"]):
            if os.path.exists(self.so_path(flags)):
                return self.so_path(flags)
        missing = [p for p in self.absolute_sources() if not os.path.exists(p)]
        if missing:
            raise RuntimeError(f"op '{self.NAME}': sources missing: {missing}")
        if shutil.which("g++") is None:
            raise RuntimeError(f"op '{self.NAME}' needs g++ to build its C++ sources, and "
                               "there is none on the PATH: the host ops have no other path")
        log = self._compile(FLAGS)
        if log is None:
            return self.so_path(FLAGS)
        # JAX's retry: the same build without native tuning
        retry = [f for f in FLAGS if f != "-march=native"]
        log2 = self._compile(retry)
        if log2 is None:
            return self.so_path(retry)
        raise RuntimeError(f"build of op '{self.NAME}' failed:\n{log}\n--- retry without "
                           f"-march=native:\n{log2}")

    def load(self) -> ctypes.CDLL:
        """Build if needed, load and bind the library (one load a path per
        process)."""
        with _LOCK:
            path = self.build()
            lib = _LIBS.get(path)
            if lib is None:
                lib = ctypes.CDLL(path)
                self._bind(lib)
                _LIBS[path] = lib
            return lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        """Declare the entry points' argtypes and restypes."""


class AsyncIOBuilder(OpBuilder):
    """The async I/O engine (the reference's ``op_builder/async_io.py``)."""

    NAME = "async_io"
    SOURCES = ["host/aio_engine.cpp"]

    def _bind(self, lib):
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.aio_create.restype = vp
        lib.aio_create.argtypes = [ci, ci]
        lib.aio_destroy.restype = None
        lib.aio_destroy.argtypes = [vp]
        for fn in (lib.aio_submit_read, lib.aio_submit_write):
            fn.restype = i64
            fn.argtypes = [vp, ctypes.c_char_p, i64, i64, vp]
        for fn in (lib.aio_poll, lib.aio_wait):
            fn.restype = ci
            fn.argtypes = [vp, i64]
        for fn in (lib.aio_wait_all, lib.aio_pending):
            fn.restype = ci
            fn.argtypes = [vp]


class HostAdamBuilder(OpBuilder):
    """Host AdamW / Lion (the reference's ``op_builder/cpu_adam.py``)."""

    NAME = "host_adam"
    SOURCES = ["host/host_adam.cpp"]

    def _bind(self, lib):
        vp, i64, f = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        adam = [vp, vp, vp, vp, i64, f, f, f, f, f, i64]
        for fn in (lib.host_adamw_fp32, lib.host_adamw_bf16grad):
            fn.restype = None
            fn.argtypes = adam
        lib.host_lion_fp32.restype = None
        lib.host_lion_fp32.argtypes = [vp, vp, vp, i64, f, f, f, f]
        lib.host_adam_num_threads.restype = ctypes.c_int
        lib.host_adam_num_threads.argtypes = []


ALL_OPS = {b.NAME: b for b in (AsyncIOBuilder(), HostAdamBuilder())}


def get_builder(name: str) -> OpBuilder:
    return ALL_OPS[name]


def op_report() -> Dict[str, Dict[str, bool]]:
    """Per op: whether it can be built here and whether it is built (the
    reference's ``ds_report`` table)."""
    return {name: {"compatible": b.is_compatible(),
                   "built": b.sources_exist() and os.path.exists(b.so_path())}
            for name, b in ALL_OPS.items()}
