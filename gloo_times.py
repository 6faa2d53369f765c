#!/usr/bin/env python3
"""Time the collectives of ranks that share one card over gloo.

    python3 gloo_times.py [--world 4] [--reps 10]

Spawns ``--world`` ranks on ``cuda:0`` (``repro_torch.parallel.spmd``,
gloo: NCCL refuses two ranks on one GPU) and times, on each rank's host
clock with the card drained after the calls: an all-reduce of a decode
step's activation (4 x 1 x 4096 bfloat16, 32 KiB) and of a prefill's
(4 x 256 x 4096, 8 MiB), and two ways of gathering a rank's logits (4 x 1
x 16384 float32) over the ranks: through host memory (the route
``ShardedRun.all_gather`` takes, chosen from the group's backend and the
tensor's device: gloo gathers no CUDA tensor) and as an all-reduce of a zero-filled buffer of the gathered
size.  Prints one JSON line a rank, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def rank_times(rank, world, reps):
    import torch
    import torch.distributed as dist

    c = torch.ops._c10d_functional
    name = dist.group.WORLD.group_name
    dev = torch.device("cuda", torch.cuda.current_device())

    def ms(fn, n):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def reduce(x):
        return c.wait_tensor(c.all_reduce(x, "sum", name))

    step = torch.randn(4, 1, 4096, device=dev).bfloat16()
    prefill = torch.randn(4, 256, 4096, device=dev).bfloat16()
    logits = torch.randn(4, 1, 16384, device=dev)
    n = logits.shape[-1]

    def staged():
        y = logits.movedim(-1, 0).contiguous().cpu()
        y = c.wait_tensor(c.all_gather_into_tensor(y, world, name))
        return y.to(dev).movedim(0, -1).contiguous()

    def zero_filled():
        buf = torch.zeros(4, 1, n * world, device=dev)
        buf[..., rank * n:(rank + 1) * n] = logits
        return reduce(buf)

    return dict(rank=rank, world=world,
                all_reduce_32KiB_ms=ms(lambda: reduce(step), 5 * reps),
                all_reduce_8MiB_ms=ms(lambda: reduce(prefill), reps),
                gather_through_host_ms=ms(staged, 5 * reps),
                gather_by_all_reduce_ms=ms(zero_filled, 5 * reps),
                gathers_equal=bool(torch.equal(staged(), zero_filled())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gloo_times: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.parallel import spmd

    with tempfile.TemporaryDirectory() as d:
        out = spmd.run(rank_times, args.world, store_dir=d, backend="gloo",
                       device="cuda:0", args=(args.reps,), timeout=300)
    for r in out:
        print(json.dumps(r))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
