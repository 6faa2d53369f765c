#!/usr/bin/env python3
"""Time the attention kernels of one or more checkouts on one card, in
turns, so that two versions are compared within one call.

    python3 attention_times.py                       # this checkout
    python3 attention_times.py build/parent . . build/parent
    python3 attention_times.py --split [checkout ...]

Each argument is the root of a checkout of this repository (a parent
unpacked with ``git archive``, for example); each runs in a process of
its own, in the order given, and builds its own kernels into its own
``build/repro_torch/``.  For each the script prints one JSON line:

- ``fwd5``, ``fwd5L``, ``fwd5D``: ``flash_attention`` without grad (the
  forward kernel storing no log-sum-exp) at ``chip_smoke.py``'s rows 5
  (B=4 S=256 H=32 KH=8 D=64), 5L (B=2 S=4096) and 5D (B=1 S=4096 H=64
  D=128), bfloat16; with ``_lse``, the same kernel keeping each row's
  log-sum-exp, where the checkout's wrapper can;
- ``fwd192``, ``fwd192L``: the same at rows 5M (MLA's prefill, B=4 S=256
  H=KH=16, q and k at head dim 192) and 5ML (B=1 S=4096), v at MLA's
  width 128 where the checkout's kernel takes it (else zero-padded to
  192, as its model calls it); ``_pad``, v zero-padded to 192 in a
  checkout that takes 128 (the kernel's equal-width instance);
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
generator.

``--split`` builds each checkout's ``csrc/flash_attention.cu`` again with
``-DFA_STAMPS`` into ``build/stamps/`` and times the parts of the
bfloat16 forward at rows 5M and 5ML from the ``clock64()`` stamps that its
consumer warpgroups record (the source's note on ``FA_STAMPS``): for
each launch (``SPLIT_REPS``, after a warm-up) the critical CTA's (the
last to finish) prologue (its start to its first item's S_0 done), tile
loop (S_0 done to the last P.V done), epilogue (to its output's stores
issued) and, with more items a CTA, the time between items, in µs at
the SM clock that the stamps' ``%globaltimer`` gives, beside the mean of
every CTA and the launch's time from CUDA events; one JSON line a
checkout and shape, medians over the launches.  A checkout whose source
has no stamps is skipped.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FWD = {"fwd5": (4, 256, 32, 8, 64), "fwd5L": (2, 4096, 32, 8, 64),
       "fwd5D": (1, 4096, 64, 8, 128)}
FWD192 = {"fwd192": (4, 256, 16, 16), "fwd192L": (1, 4096, 16, 16)}
BWD = {"bwd64": (1, 4096, 32, 8, 64), "bwd80": (1, 4096, 32, 8, 80),
       "bwd128": (1, 4096, 64, 8, 128), "bwd64_b2s1k": (2, 1024, 32, 8, 64),
       "bwd192": (1, 4096, 16, 16, 192)}
SPLIT_REPS = 20


def takes_dv(build) -> bool:
    """Does this checkout's forward entry take v's width (D_v)?"""
    return len(build.PROTOTYPES["flash_attention_fwd"]) >= 13


def takes_q_start(build) -> bool:
    """Does it take ``q_start`` and the bfloat16-score flag too?"""
    return len(build.PROTOTYPES["flash_attention_fwd"]) >= 15


def time_tree(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.kernels import build
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
    dv = 128 if takes_dv(build) else 192
    for name, (B, S, H, KH) in FWD192.items():
        q, k = randn(B, S, H, 192), randn(B, S, KH, 192)
        v = randn(B, S, KH, 128)
        vp = torch.nn.functional.pad(v, (0, 64))
        res[name] = CS.cuda_ms(lambda: KA.flash_attention(
            q, k, v if dv == 128 else vp), torch, 20)
        if dv == 128:
            res[name + "_pad"] = CS.cuda_ms(
                lambda: KA.flash_attention(q, k, vp), torch, 20)
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


def split_tree(tree: str) -> list:
    """The stamped forward's parts at rows 5M and 5ML (the module's
    docstring), one dict a shape and v width; [] without stamps."""
    import ctypes

    import numpy as np
    import torch

    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as CS
    from repro_torch.kernels import build

    src = root / "src/repro_torch/csrc/flash_attention.cu"
    if "FA_STAMPS" not in src.read_text():
        return []
    out = root / "build/stamps/libfa_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH, *build.FLAGS, "-DFA_STAMPS",
                    "-shared", "-I", str(src.parent), "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    fwd = lib.flash_attention_fwd
    fwd.argtypes = build.PROTOTYPES["flash_attention_fwd"]
    fwd.restype = ctypes.c_int
    lib.flash_attention_stamps.argtypes = [ctypes.c_void_p]
    words = 1024 * 2 * (4 + 6 * 4)
    host = np.zeros(words, dtype=np.uint64)
    dev = torch.device("cuda:0")
    gen = torch.Generator(dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    widths = (128, 192) if takes_dv(build) else (192,)
    for name, (B, S, H, KH) in FWD192.items():
        for dv in widths:
            q, k = (torch.randn((B, S, h, 192), generator=gen, device=dev)
                    .to(torch.bfloat16) for h in (H, KH))
            v = torch.randn((B, S, KH, dv), generator=gen, device=dev).to(
                torch.bfloat16)
            o = torch.empty((B, S, H, dv), dtype=torch.bfloat16, device=dev)
            args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, B, S, H, KH, 192] + ([dv] if takes_dv(build)
                                               else []) + [1] + (
                [0, 0] if takes_q_start(build) else []) + [stream]

            def launch():
                err = fwd(*args)
                if err:
                    raise RuntimeError(f"flash_attention_fwd: error {err}")

            parts = {k: [] for k in ("prologue", "loop", "epilogue",
                                     "between", "cta_total", "mean_prologue",
                                     "mean_loop", "mean_epilogue")}
            event_us, tiles = [], None
            for rep in range(SPLIT_REPS + 1):
                torch.cuda.synchronize()
                lib.flash_attention_stamps(host.ctypes.data)  # zero them
                t_us = CS.cuda_ms(launch, torch, 1) * 1e3
                torch.cuda.synchronize()
                lib.flash_attention_stamps(host.ctypes.data)
                if rep == 0:
                    continue                      # warm-up
                event_us.append(t_us)
                st = host.reshape(1024, 2, 4 + 6 * 4).astype(np.float64)
                live = st[:, :, 2] > 0            # a warpgroup that ended
                cyc_ns = ((st[:, :, 2] - st[:, :, 0])[live]
                          / (st[:, :, 3] - st[:, :, 1])[live])
                per_us = 1.0 / (float(np.median(cyc_ns)) * 1e3)
                item = st[:, :, 4:].reshape(1024, 2, 4, 6)
                has = item[..., 5] > 0            # items this CTA ran
                pro = (item[:, :, 0, 1] - st[:, :, 0])[live]
                loop = ((item[..., 2] - item[..., 1]) * has).sum(-1)[live]
                epi = ((item[..., 3] - item[..., 2]) * has).sum(-1)[live]
                gap = ((item[:, :, 1:, 0] - item[:, :, :-1, 3])
                       * has[:, :, 1:]).sum(-1)[live]
                total = (st[:, :, 2] - st[:, :, 0])[live]
                crit = int(np.argmax(total))
                for key, arr in (("prologue", pro), ("loop", loop),
                                 ("epilogue", epi), ("between", gap),
                                 ("cta_total", total)):
                    parts[key].append(float(arr[crit]) * per_us)
                for key, arr in (("mean_prologue", pro), ("mean_loop", loop),
                                 ("mean_epilogue", epi)):
                    parts[key].append(float(arr.mean()) * per_us)
                tiles = sorted(set(int(x) for x in item[..., 4][has]))
            row = {"tree": tree, "shape": name, "B": B, "S": S, "H": H,
                   "D": 192, "Dv": dv, "tiles_an_item": tiles,
                   "event_us": float(np.median(event_us)),
                   "sm_mhz": 1.0 / per_us}
            row.update({k + "_us": float(np.median(v))
                        for k, v in parts.items()})
            rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device visible", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--one-split":
        for row in split_tree(sys.argv[2]):
            print(json.dumps(row), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rc = 0
    split = sys.argv[1:2] == ["--split"]
    trees = sys.argv[2 if split else 1:] or ["."]
    for tree in trees:
        run = subprocess.run([sys.executable, __file__,
                              "--one-split" if split else "--one", tree],
                             cwd=Path(__file__).resolve().parent)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
