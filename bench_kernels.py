"""Device times of one kernel family of one checkout.

    python3 bench_kernels.py --family qmm|paged|quant_rows [--root DIR] [--label NAME] [--out FILE]

Imports ``deepspeed_tpu_torch`` from DIR (default: the checkout this script
is in), builds its kernels and times one family the way ``chip_smoke.py``
does, with this checkout's timing helpers whatever checkout the kernels come
from:

- ``qmm``: the dequant-matmuls (K4 int8 / e4m3, K5 fp6) at every llama3_8b
  serving-matmul shape at M 16 (decode) and M 512 (prefill)
  (``chip_smoke.qmm_shape_times``), beside ``torch.matmul`` on the
  dequantized bf16 weight;
- ``paged``: K2 at the 410M decode shape and gpt2_small's, K3 on the
  scheduler's and a verify tick's pack, and both partial modes
  (``chip_smoke.paged_timings``), beside their SDPA yardsticks;
- ``quant_rows``: the row quantizers K6a (int8), K6c (e4m3, and e5m2) and
  the dequantizer K6b on [4096, 14336] bf16 (``chip_smoke.quant_row_times``),
  and how many bytes, scales and dequantized values of the checkout's
  kernels differ from its plain versions on ``chip_smoke.row_quant_inputs``
  (edge rows with inf, NaN and subnormals, ragged and unaligned shapes).

Each kernel by CUDA-graph replay (``ms``) and back-to-back eager calls
(``eager_ms``).  The inputs come from a fixed seed, so two checkouts see the
same data.  To compare a commit with its parent on one card, unpack the
parent with ``git archive`` into a gitignored directory and run parent,
change, change, parent one after another on the same card::

    python3 bench_kernels.py --family paged --root scratch_dev/parent --label parent --out k.jsonl
    python3 bench_kernels.py --family paged --label change --out k.jsonl

Prints the card's name and power limit, then one JSON line (appended to
FILE too).  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("qmm", "paged", "quant_rows"), required=True)
    ap.add_argument("--root", default=HERE, help="checkout whose deepspeed_tpu_torch is timed")
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None, help="file the JSON line is appended to")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "deepspeed_tpu_torch")):
        sys.exit(f"bench_kernels: no deepspeed_tpu_torch under {root}")
    sys.path.insert(0, root)
    # this checkout's timing helpers, whatever checkout the kernels come from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_kernels: no CUDA device")
    import deepspeed_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))) != root:
        sys.exit(f"bench_kernels: deepspeed_tpu_torch came from {deepspeed_tpu_torch.__file__}")
    card = smoke.gpu_line()
    print(card, flush=True)
    if args.family == "qmm":
        gen = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED + 30)
        times = smoke.qmm_shape_times(torch, gen, plain=False)
    elif args.family == "paged":
        gen = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED + 40)
        times = smoke.paged_timings(torch, gen, plain=False)
    else:
        from deepspeed_tpu_torch.ops.kernels import quant_kernel as QK

        gen = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED + 30)
        times = smoke.quant_row_times(torch, gen, plain=False)
        gen = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED + 20)
        times["agreement_with_plain"] = {
            f"{label}_to_{dtype}": smoke.row_quant_agreement(torch, QK, x, dtype)
            for label, x in smoke.row_quant_inputs(torch, gen) for dtype in smoke.K6_DTYPES}
    line = json.dumps({"label": args.label, "root": os.path.relpath(root, HERE), "card": card,
                       "family": args.family, args.family: times})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
