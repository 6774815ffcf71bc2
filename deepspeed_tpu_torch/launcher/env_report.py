"""`dstpu_torch_report` — environment / compatibility report, counterpart
of ``deepspeed_tpu/launcher/env_report.py`` (reference: bin/ds_report ->
deepspeed/env_report.py).

Reports torch and the CUDA it was built for, ``nvcc`` and ``g++`` (the
kernels' and the host ops' compilers), each GPU's name and power limit as
``nvidia-smi`` gives them, ``triton``, the CUDA kernels' and host ops'
build state, and the port's version — in place of JAX's jax, TPU devices
and Pallas lines.  A tool that is missing is reported as ``MISSING`` with
what was looked for; no field is filled with a guess.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

MISSING = "MISSING"


def _run(argv, timeout: float = 20.0):
    """A tool's stdout lines, or None when it is missing or fails."""
    try:
        out = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _nvcc_path():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    return None


def collect() -> dict:
    info: dict = {}
    import torch

    info["torch"] = torch.__version__
    info["torch_cuda"] = torch.version.cuda or f"{MISSING} (a CPU-only torch build)"
    info["cuda_available"] = torch.cuda.is_available()
    info["device_count"] = torch.cuda.device_count() if torch.cuda.is_available() else 0
    smi = shutil.which("nvidia-smi")
    if smi is None:
        info["gpus"] = f"{MISSING} (nvidia-smi not on PATH)"
    else:
        rows = _run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"])
        info["gpus"] = rows if rows is not None else f"{MISSING} (nvidia-smi failed)"
    nvcc = _nvcc_path()
    if nvcc is None:
        info["nvcc"] = f"{MISSING} (PATH, $CUDA_HOME/bin)"
    else:
        rows = _run([nvcc, "--version"])
        info["nvcc"] = f"{nvcc}: {rows[-1]}" if rows else f"{MISSING} ({nvcc} --version failed)"
    gxx = shutil.which("g++")
    if gxx is None:
        info["g++"] = f"{MISSING} (not on PATH)"
    else:
        rows = _run([gxx, "--version"])
        info["g++"] = rows[0] if rows else f"{MISSING} (g++ --version failed)"
    for mod in ("triton", "numpy", "einops", "scipy"):
        try:
            m = __import__(mod)
            info[mod] = getattr(m, "__version__", "present")
        except ImportError:
            info[mod] = MISSING
    from ..ops import kernels

    for src in sorted(set(kernels.SOURCES.values())):
        info[f"kernel/{src}"] = "built" if os.path.exists(kernels._lib_path(src)) else \
            "not built (nvcc builds it at first use)"
    from ..ops.op_builder import op_report

    for name, st in op_report().items():
        info[f"op/{name}"] = (("compatible" if st["compatible"] else "INCOMPATIBLE")
                              + (", built" if st["built"] else ""))
    import deepspeed_tpu_torch

    info["deepspeed_tpu_torch"] = deepspeed_tpu_torch.__version__
    return info


def main() -> int:
    info = collect()
    width = max(len(k) for k in info)
    print("-" * 50)
    print("deepspeed_tpu_torch environment report")
    print("-" * 50)
    for k, v in info.items():
        print(f"{k:<{width}}  {v}")
    print("-" * 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
