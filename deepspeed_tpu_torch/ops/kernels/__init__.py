"""Hand-written CUDA kernels for Hopper — the counterpart of
``deepspeed_tpu/ops/pallas``.

Each kernel module holds a plain PyTorch version of its function and a
wrapper around the CUDA kernel.  The wrapper dispatches on the tensor's
device: a CPU tensor takes the plain version (the CPU tests), a CUDA tensor
launches the kernel or raises — there is no fallback from a kernel that
fails to build or launch.

Kernels are CUDA C++ under ``deepspeed_tpu_torch/csrc``, compiled with
``nvcc`` for ``sm_90a`` into one shared library per source (plain C
interface, loaded with ``ctypes``) at first use, all sources in parallel,
into ``csrc/build/<source hash>/``.  Nothing is built at import.

``LAUNCHES`` counts each wrapper's kernel launches, so a run can show that
its main path went through the kernels.  A launch recorded into a
``CapturedGraph`` counts once per replay of the graph, not at capture.

Inside ``count_kernel_flops()`` the training path's attention wrappers
(K1f, K1b, K7f, K7b) also add the operations of each launch to
``KERNEL_FLOPS``: a ``ctypes`` launch is invisible to PyTorch's
``FlopCounterMode``, which the flops profiler reads for everything else.

A kernel that fails to build, load or launch raises ``KernelError``;
``surfaces(exc)`` says whether an exception is such a fault (or any CUDA
error, or one raised inside this package's wrappers), which the serving
stack's retry and isolation guards re-raise untouched instead of turning
it into a failed request.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Optional

import torch

class KernelError(RuntimeError):
    """A CUDA kernel of this package failed to build, load or launch."""


def surfaces(exc: BaseException) -> bool:
    """Whether ``exc`` is a kernel or device fault that must reach the
    caller as it is: a ``KernelError``, a CUDA error from PyTorch
    (``torch.AcceleratorError``, ``torch.cuda.OutOfMemoryError``, or a
    ``RuntimeError`` naming CUDA), or any exception raised inside a kernel
    wrapper of this package (its traceback passes through this package's
    directory).  Serving's transient-retry and per-request isolation
    guards consult this first: such an error is never retried and never
    becomes a FAILED request."""
    if isinstance(exc, KernelError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exc, RuntimeError) and "CUDA" in str(exc):
        return True
    tb = exc.__traceback__
    while tb is not None:
        if os.path.dirname(os.path.abspath(tb.tb_frame.f_code.co_filename)) == _HERE:
            return True
        tb = tb.tb_next
    return False


_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> source file.  One library per source: the decode kernel's
# head_dim-64 instantiation (the counterpart of the TPU's lane-packed K2p)
# counts under its own name, and so do the partial modes of the decode and
# packed-context kernels (seq-sharded serving); both backward kernels live
# in flash_bwd.cu and the block-sparse forward, dq and dk/dv kernels in
# sparse_flash.cu; the int8 / e4m3 / fp6 dequant-matmuls share
# quant_matmul.cu and the row quantizers quantize.cu, each format counted
# under its own name.
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd.cu",
    "flash_bwd_dkv": "flash_bwd.cu",
    "paged_decode": "paged_decode.cu",
    "paged_decode_hd64": "paged_decode.cu",
    "paged_decode_partial": "paged_decode.cu",
    "ctx_attention": "ctx_attention.cu",
    "ctx_attention_partial": "ctx_attention.cu",
    "quant_matmul_int8": "quant_matmul.cu",
    "quant_matmul_fp8": "quant_matmul.cu",
    "quant_matmul_fp6": "quant_matmul.cu",
    "quantize_int8": "quantize.cu",
    "quantize_fp8": "quantize.cu",
    "dequantize": "quantize.cu",
    "sparse_fwd": "sparse_flash.cu",
    "sparse_bwd_dq": "sparse_flash.cu",
    "sparse_bwd_dkv": "sparse_flash.cu",
    "fused_adamw": "fused_adam.cu",
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}  # source file -> loaded library
_PTR, _INT, _FLOAT, _INT64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of the extern "C" entry points (each returns cudaError_t)
_ARGTYPES = {
    "flash_fwd": ("dst_flash_fwd", [_PTR] * 6 + [_INT] * 5 + [_FLOAT, _FLOAT, _PTR]),
    "flash_bwd_dq": ("dst_flash_bwd_dq",
                     [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _FLOAT, _PTR]),
    "flash_bwd_dkv": ("dst_flash_bwd_dkv",
                      [_PTR] * 9 + [_INT] * 5 + [_FLOAT, _FLOAT, _PTR]),
    **{name: ("dst_paged_decode", [_PTR] * 6 + [_INT] * 7 + [_FLOAT, _FLOAT, _PTR])
       for name in ("paged_decode", "paged_decode_hd64")},
    "paged_decode_partial": ("dst_paged_decode_partial",
                             [_PTR] * 8 + [_INT] * 7 + [_FLOAT, _FLOAT, _PTR]),
    "ctx_attention": ("dst_ctx_attention",
                      [_PTR] * 9 + [_INT] * 8 + [_FLOAT, _FLOAT, _PTR]),
    "ctx_attention_partial": ("dst_ctx_attention_partial",
                              [_PTR] * 11 + [_INT] * 9 + [_FLOAT, _FLOAT, _PTR]),
    **{name: ("dst_quant_matmul", [_PTR] * 6 + [_INT] * 9 + [_PTR])
       for name in ("quant_matmul_int8", "quant_matmul_fp8", "quant_matmul_fp6")},
    **{name: ("dst_quantize_rows", [_PTR] * 3 + [_INT] * 4 + [_FLOAT, _PTR])
       for name in ("quantize_int8", "quantize_fp8")},
    "dequantize": ("dst_dequantize_rows", [_PTR] * 3 + [_INT] * 4 + [_PTR]),
    "sparse_fwd": ("dst_sparse_fwd", [_PTR] * 10 + [_INT] * 7 + [_FLOAT, _FLOAT, _PTR]),
    "sparse_bwd_dq": ("dst_sparse_bwd_dq", [_PTR] * 12 + [_INT] * 7 + [_FLOAT, _FLOAT, _PTR]),
    "sparse_bwd_dkv": ("dst_sparse_bwd_dkv",
                       [_PTR] * 13 + [_INT] * 7 + [_FLOAT, _FLOAT, _PTR]),
    "fused_adamw": ("dst_fused_adamw", [_PTR] * 4 + [_INT64] + [_PTR] * 3 + [_FLOAT] * 6 + [_PTR]),
}


def on_gpu() -> bool:
    """Counterpart of ``ops/pallas.on_tpu``: a CUDA device is present."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no CUDA device and no explicit device this raises — an
    entry point never carries on quietly on the CPU."""
    if device is None:
        if not on_gpu():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "path explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not on_gpu():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# kernel name -> operations launched inside ``count_kernel_flops``
KERNEL_FLOPS: Dict[str, int] = {}
_FLOP_COUNTING = {"depth": 0}


@contextmanager
def count_kernel_flops():
    """Count the attention kernels' operations into ``KERNEL_FLOPS``
    (cleared on entry) while the block runs.  Counting a launch with
    segment ids reads the ids' pair count back to the host, so counting is
    off outside such a block."""
    KERNEL_FLOPS.clear()
    _FLOP_COUNTING["depth"] += 1
    try:
        yield KERNEL_FLOPS
    finally:
        _FLOP_COUNTING["depth"] -= 1


def add_flops(name: str, count: Callable[[], int]) -> None:
    """Add ``count()`` operations to kernel ``name`` inside
    ``count_kernel_flops`` (``count`` is not called outside it)."""
    if _FLOP_COUNTING["depth"]:
        KERNEL_FLOPS[name] = KERNEL_FLOPS.get(name, 0) + int(count())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built, and a CUDA tensor has no other path")


def _local_includes(src: str) -> list:
    """``src`` and the ``csrc`` headers it includes (``#include "..."``),
    transitively, in first-seen order."""
    seen = [src]
    for f in seen:
        with open(os.path.join(CSRC, f)) as fh:
            for line in fh:
                parts = line.split('"')
                if line.startswith("#include") and len(parts) > 1 and parts[1] not in seen:
                    seen.append(parts[1])
    return seen


def _source_hash(src: str) -> str:
    """The build key: the flags, the source and the headers it includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _local_includes(src):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _lib_path(src: str) -> str:
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_ROOT, _source_hash(src), f"lib{stem}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the source of every named kernel whose library is missing,
    one ``nvcc`` per source, all started together; load them.  Returns
    ``{"seconds": wall time, "built": sources compiled}``.  A failed compile
    raises with the compiler's output."""
    srcs = sorted({SOURCES[n] for n in (names if names is not None else SOURCES)})
    todo = [s for s in srcs if s not in _LIBS and not os.path.exists(_lib_path(s))]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for src in todo:
            out = _lib_path(src)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, out)
        errors = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            with open(out + ".log", "w") as fh:
                fh.write(log)
            if proc.returncode != 0:
                errors.append(f"--- {src} (nvcc exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise KernelError("CUDA kernel build failed:\n" + "\n".join(errors))
    for src in srcs:
        _load(src)
    return {"seconds": time.perf_counter() - t0, "built": len(todo)}


def build_log(src: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of source ``src`` (e.g. ``flash_bwd.cu``)."""
    path = _lib_path(src) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def _load(src: str) -> ctypes.CDLL:
    if src not in _LIBS:
        lib = ctypes.CDLL(_lib_path(src))
        for name in (n for n, s in SOURCES.items() if s == src):
            sym, argtypes = _ARGTYPES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[src] = lib
    return _LIBS[src]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on the current stream and count the
    launch; raises when the launch was refused (``cudaGetLastError``).

    On a capturing stream the call records the launch into the graph;
    ``CapturedGraph`` moves that count from capture time to each replay.
    Nothing is built under a capture: the first call of a kernel runs
    eagerly before its graph is captured."""
    if SOURCES[name] not in _LIBS and torch.cuda.is_current_stream_capturing():
        raise KernelError(f"CUDA kernel {name} was not built before a CUDA-graph capture: "
                           "run the captured function once eagerly first")
    build([name])
    sym, _ = _ARGTYPES[name]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(_LIBS[SOURCES[name]], sym)(*args, stream)
    if err != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


class CapturedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the kernel launches
    captured in it: ``capture(fn)`` records ``fn``'s work (run ``fn`` once
    eagerly before, so every kernel is built and configured), ``replay()``
    runs it and adds the captured launches to ``LAUNCHES``.  Tensors that
    ``fn`` allocates live in the graph's private memory pool for as long as
    the graph does."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}

    def capture(self, fn, stream: Optional["torch.cuda.Stream"] = None,
                generators: Iterable[torch.Generator] = ()):
        """Capture ``fn()`` on ``stream`` (a side stream by default) and
        return what it returns.  ``generators``: the CUDA generators ``fn``
        draws from, registered with the graph so each replay draws anew
        (the default generator is registered by PyTorch itself)."""
        for gen in generators:
            if not hasattr(self.graph, "register_generator_state"):
                raise NotImplementedError(
                    f"PyTorch {torch.__version__} cannot capture draws from a torch.Generator "
                    "(CUDAGraph.register_generator_state is missing)")
            self.graph.register_generator_state(gen)
        before = dict(LAUNCHES)
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                out = fn()
        finally:
            # the calls recorded launches that run only at replay
            self.launches = {n: LAUNCHES[n] - c for n, c in before.items() if LAUNCHES[n] != c}
            LAUNCHES.update(before)
        return out

    def replay(self) -> None:
        self.graph.replay()
        for n, c in self.launches.items():
            LAUNCHES[n] += c


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """The tensor's device address (null for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Wrapper-side argument checks shared by the kernels: one CUDA device,
    contiguous, 16-byte aligned; ``dtype`` applies to the first tensor
    group (the caller passes int32 tensors separately)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


# the head dims every attention kernel is instantiated for (csrc/flash_tc.cuh:
# K1 and K7; csrc/paged_tc.cuh: K2 and K3), each at any query group
class _RefuseDoubleBackward(torch.autograd.Function):
    """Identity on a backward's outputs whose own backward raises: the node
    ``once_differentiable`` puts in a double backward's path."""

    @staticmethod
    def forward(ctx, n: int, *tensors):
        return tuple(t.clone() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("trying to differentiate twice a function that was marked with "
                           "@once_differentiable: the flash attention kernels have no "
                           "second derivative (use attn_impl='reference')")


def once_differentiable(backward: Callable) -> Callable:
    """``torch.autograd.function.once_differentiable`` for a Function whose
    backward launches a kernel: the backward runs without a graph, and under
    ``create_graph`` its outputs pass through a node that raises when a
    second derivative reaches it.  PyTorch's own decorator puts its error
    node on the outputs alone, with no edge to the inputs, so
    ``torch.autograd.grad(..., inputs)`` prunes it and returns a second
    derivative without this Function's term; here the node is linked to the
    saved tensors and the incoming gradients, so every path that needs the
    term meets it."""
    import functools

    @functools.wraps(backward)
    def wrapper(ctx, *grad_outputs):
        with torch.no_grad():
            outs = backward(ctx, *grad_outputs)
        if not torch.is_grad_enabled():
            return outs
        links = [t for t in (*ctx.saved_tensors, *grad_outputs)
                 if torch.is_tensor(t) and t.requires_grad]
        if not links:
            return outs
        outs = list(outs)
        idx = [i for i, t in enumerate(outs) if torch.is_tensor(t)]
        guarded = _RefuseDoubleBackward.apply(len(idx), *[outs[i] for i in idx], *links)
        for i, t in zip(idx, guarded):
            outs[i] = t
        return tuple(outs)

    return wrapper


HEAD_DIMS = (64, 128, 256)


def check_heads(name: str, hq: int, hkv: int, hd: int) -> None:
    """Head-shape validation of the attention wrappers, run before any
    device check: ``hkv`` must divide ``hq``; a head_dim outside
    ``HEAD_DIMS`` is a shape the kernels do not take yet and raises
    ``NotImplementedError``."""
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"{name}: hkv {hkv} must divide hq {hq}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: head_dim {hd} is not ported to the card yet (ROADMAP queue 2); "
            f"the kernels take head_dim {' or '.join(map(str, HEAD_DIMS))}")


def scalars(scale: float, soft_cap: Optional[float]):
    """(scale, cap) as C floats; cap <= 0 means no soft cap."""
    cap = float(soft_cap) if soft_cap is not None else 0.0
    if soft_cap is not None and cap <= 0:
        raise ValueError(f"logits_soft_cap must be > 0, got {soft_cap}")
    return ctypes.c_float(float(scale)), ctypes.c_float(cap)
