#!/usr/bin/env python3
"""Time the attention kernels of one or more checkouts on one card, in
turns, so that two versions are compared within one call.

    python3 attention_times.py                       # this checkout
    python3 attention_times.py build/parent . . build/parent

Each argument is the root of a checkout of this repository (a parent
unpacked with ``git archive``, for example); each runs in a process of
its own, in the order given, and builds its own kernels into its own
``build/repro_torch/``.  For each the script prints one JSON line:

- ``fwd5``, ``fwd5L``, ``fwd5D``: ``flash_attention`` without grad (the
  forward kernel storing no log-sum-exp) at ``chip_smoke.py``'s rows 5
  (B=4 S=256 H=32 KH=8 D=64), 5L (B=2 S=4096) and 5D (B=1 S=4096 H=64
  D=128), bfloat16; with ``_lse``, the same kernel keeping each row's
  log-sum-exp, where the checkout's wrapper can;
- ``bwd64`` (the training packet, B=1 S=4096 H=32 KH=8 D=64), ``bwd80``,
  ``bwd128`` (B=1 S=4096 H=64 KH=8), ``bwd64_b2s1k`` (B=2 S=1024) and
  ``bwd192`` (deepseek-v2-lite-16b's training packet of one row, MLA's
  head dim: B=1 S=4096 H=KH=16 D=192):
  ``flash_attention_bwd`` fed the forward's log-sum-exp (a checkout
  without it: the old call), with ``_relerr`` its largest error over the
  three gradients against ``attention_bwd_ref``, each over that
  gradient's largest |value|, and ``name:kernel`` each of its kernels'
  device time from ``torch.profiler``.

Times are milliseconds, from ``chip_smoke.cuda_ms`` (CUDA events around
20 calls after a warm-up), on random bfloat16 inputs from a seeded
generator.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FWD = {"fwd5": (4, 256, 32, 8, 64), "fwd5L": (2, 4096, 32, 8, 64),
       "fwd5D": (1, 4096, 64, 8, 128)}
BWD = {"bwd64": (1, 4096, 32, 8, 64), "bwd80": (1, 4096, 32, 8, 80),
       "bwd128": (1, 4096, 64, 8, 128), "bwd64_b2s1k": (2, 1024, 32, 8, 64),
       "bwd192": (1, 4096, 16, 16, 192)}


def time_tree(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA

    dev = torch.device("cuda:0")
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    keeps_lse = hasattr(KA, "flash_attention_fwd")
    res = {"tree": tree}
    for name, (B, S, H, KH, D) in FWD.items():
        q, k, v = randn(B, S, H, D), randn(B, S, KH, D), randn(B, S, KH, D)
        res[name] = CS.cuda_ms(lambda: KA.flash_attention(q, k, v), torch,
                               20)
        if keeps_lse:
            res[name + "_lse"] = CS.cuda_ms(lambda: KA.flash_attention_fwd(
                q, k, v, keep_lse=True), torch, 20)
    for name, (B, S, H, KH, D) in BWD.items():
        q, k, v = randn(B, S, H, D), randn(B, S, KH, D), randn(B, S, KH, D)
        dout = randn(B, S, H, D)
        if keeps_lse:
            out, lse = KA.flash_attention_fwd(q, k, v, keep_lse=True)

            def bwd():
                return KA.flash_attention_bwd(q, k, v, out, dout, lse)
        else:
            out = KA.flash_attention(q, k, v)

            def bwd():
                return KA.flash_attention_bwd(q, k, v, out, dout)
        want = RA.attention_bwd_ref(q, k, v, out, dout)
        res[name + "_relerr"] = max(
            float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for g, w in zip(bwd(), want))
        res[name] = CS.cuda_ms(bwd, torch, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                bwd()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "bwd_" in e.key):
                kernel = e.key.split("::")[-1].split("(")[0]
                res[f"{name}:{kernel}"] = getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 5e3
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device visible", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_tree(sys.argv[2])), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rc = 0
    for tree in sys.argv[1:] or ["."]:
        run = subprocess.run([sys.executable, __file__, "--one", tree],
                             cwd=Path(__file__).resolve().parent)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
