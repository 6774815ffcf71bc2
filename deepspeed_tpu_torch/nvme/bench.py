"""ds_io-style throughput benchmark of the async I/O engine — counterpart
of ``deepspeed_tpu/nvme/bench.py`` (the reference's ``bin/ds_io``).

    python -m deepspeed_tpu_torch.nvme.bench --dir <directory> --size-mb 256 \
        --threads 8 --ops 16

prints one JSON object: write and read GB/s (GiB of data per second, as
JAX counts) of ``ops`` files that together hold ``size_mb`` MiB.  Reads
may be served from the page cache right after the writes.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .aio import AsyncIOEngine


def run_bench(path_dir: str, size_mb: int, threads: int, ops: int) -> dict:
    os.makedirs(path_dir, exist_ok=True)
    chunk = size_mb * 1024 * 1024 // ops
    eng = AsyncIOEngine(num_threads=threads)
    gen = torch.Generator().manual_seed(0)
    bufs = [torch.randint(0, 255, (chunk,), dtype=torch.uint8, generator=gen)
            for _ in range(ops)]
    paths = [os.path.join(path_dir, f"bench_{i}.bin") for i in range(ops)]
    try:
        t0 = time.perf_counter()
        for p, b in zip(paths, bufs):
            eng.submit_write(p, b)
        eng.wait_all()
        w_dt = time.perf_counter() - t0

        reads = [torch.empty(chunk, dtype=torch.uint8) for _ in range(ops)]
        t0 = time.perf_counter()
        for p, b in zip(paths, reads):
            eng.submit_read(p, b)
        eng.wait_all()
        r_dt = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(bufs, reads)):
            raise IOError("aio bench: the bytes read back differ from those written")
    finally:
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        eng.close()
    total_gb = size_mb / 1024
    return {"write_GBps": total_gb / w_dt, "read_GBps": total_gb / r_dt, "size_mb": size_mb,
            "threads": threads, "ops": ops, "write_s": w_dt, "read_s": r_dt}


def main():
    ap = argparse.ArgumentParser(description="async-IO throughput benchmark")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--ops", type=int, default=16)
    args = ap.parse_args()
    print(json.dumps(run_bench(args.dir, args.size_mb, args.threads, args.ops)))


if __name__ == "__main__":
    main()
