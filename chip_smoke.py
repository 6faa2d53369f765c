#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's sizes, one card
    python3 chip_smoke.py --small    # small sizes: a quick build-and-run

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the four CUDA kernels from ``src/repro_torch/csrc`` (timed as
   set-up);
3. co-execute the paper's four kernel programs on ``[cuda:0, cpu]``
   through ``repro_torch.api.coexec``, with HGuidedOpt seeded from a
   one-packet probe on each group.  Every kernel's launch counter is set to
   0 just before each run and read just after; the card's group must have
   run packets, not died, and launched its kernel, and the output must
   match ``reference_output`` on the card (Mandelbrot exactly);
4. register binomial as a workload and re-offload sub-regions of it in ROI
   mode (pooled buffers, pipelined loop), with the same checks;
5. hold each kernel against its plain PyTorch version on the card, at the
   main path's largest packet on the card (or a band of it where the plain
   version is too slow), and time kernel, plain version and, for the
   blur, one ``F.conv2d`` with the 31x31 outer-product weight.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

PAPER_SIZES = {
    "gaussian": dict(h=8192, w=8192),
    "binomial": dict(n_options=4194304),
    "mandelbrot": dict(px=14336, max_iter=5000),
    "nbody": dict(n_bodies=229376),
}
# kernel against plain version (and card against host packets):
# Mandelbrot exactly, the rest as the JAX package's kernel tests hold them
TOLERANCES = {"gaussian": (1e-5, 1e-5), "binomial": (1e-4, 1e-3),
              "nbody": (2e-4, 2e-4)}
SMALL_SIZES = {
    "gaussian": dict(h=1024, w=512),
    "binomial": dict(n_options=65536),
    "mandelbrot": dict(px=512, max_iter=256),
    "nbody": dict(n_bodies=8192),
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    """A phase's check; raises (never an assert, which -O removes)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, torch, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` float32 operations on the card."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small sizes instead of the paper's")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.api import EngineSession, OffloadMode, Region, coexec
        from repro_torch.core import programs as P
        from repro_torch.core.device import DeviceGroup
        from repro_torch.kernels import build
        from repro_torch.kernels.binomial import kernel as KB, ref as RB
        from repro_torch.kernels.gaussian import kernel as KG, ref as RG
        from repro_torch.kernels.mandelbrot import kernel as KM, ref as RM
        from repro_torch.kernels.nbody import kernel as KN, ref as RN
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"the port imported {leaked}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev0 = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------- build
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {build.build_seconds:.2f} s)")
    for src, rep in sorted(build.ptxas_report.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    sizes = SMALL_SIZES if args.small else PAPER_SIZES
    kernels = {"gaussian": KG, "binomial": KB, "mandelbrot": KM,
               "nbody": KN}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def fleet():
        return [DeviceGroup("cuda0", device="cuda:0"),
                DeviceGroup("cpu", device="cpu")]

    def probe(prog, devices):
        """Computing power (work-groups/s) of each group from one packet
        in the middle of the range (a card: 1/16 of it after a warm-up;
        the host: one work-group)."""
        G = prog.total_work
        powers = []
        for d in devices:
            fn = prog.build(d)
            size = max(1, G // 16) if d.is_cuda else 1
            off = G // 2 - size // 2
            if d.is_cuda:
                d.run_packet(fn, off, size)
            _, wg_s = d.run_packet(fn, off, size)
            powers.append(wg_s)
        return powers

    def check_group(res, devices, name, used):
        gpu = devices[0]
        check(res.aborted_devices == 0, f"{name}: aborted devices")
        check(not gpu.dead, f"{name}: the card's group was marked dead")
        check(gpu.packets_done > 0, f"{name}: the card ran no packet")
        for k in used:
            check(kernels[k].launches > 0, f"{name}: {k} kernel unused")

    # ----------------------------------------------------- main path
    launches, largest = {}, {}
    outputs = {}
    for name, kw in sizes.items():
        t0 = time.perf_counter()
        prog = P.PROGRAMS[name](**kw)
        devices = fleet()
        powers = probe(prog, devices)
        setup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        res = coexec(prog, devices, powers=powers)
        wall = time.perf_counter() - t0
        counts = {k: m.launches for k, m in kernels.items()}
        check_group(res, devices, name, [name])
        launches[name] = counts[name]
        G = prog.total_work
        share = [sum(p.size for p in res.packets if p.device == i) / G
                 for i in range(len(devices))]
        gpu_pkts = [p for p in res.packets if p.device == 0]
        big = max(gpu_pkts, key=lambda p: p.size)
        largest[name] = (big.offset, big.size)
        ref = P.reference_output(name, device=dev0, **kw)
        out = res.output
        check(out.shape == ref.shape and bool(np.isfinite(out).all()),
              f"{name}: output of shape {out.shape}, not finite or not "
              f"{ref.shape}")
        if name == "mandelbrot":
            n_bad = int((out != ref).sum())
            check(n_bad == 0, f"mandelbrot: {n_bad} counts differ")
        else:
            rtol, atol = TOLERANCES[name]
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol,
                                       err_msg=name)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        if name == "binomial":
            outputs[name] = ref
        log(f"coexec {name} {kw}: set-up {setup_s:.2f} s, run "
            f"{wall:.3f} s wall, roi {res.total_time:.3f} s, powers "
            f"{[round(p, 1) for p in powers]} wg/s, share cuda0/cpu "
            f"{share[0]:.4f}/{share[1]:.4f}, packets "
            f"{len(gpu_pkts)}/{len(res.packets) - len(gpu_pkts)}, "
            f"launches {counts}, busy s cuda0/cpu "
            f"{res.device_busy[0]:.3f}/{res.device_busy[1]:.3f}, "
            f"max |out - ref| {err:.3g}")

    # ------------------------------------------------ ROI re-offload
    kw = sizes["binomial"]
    prog = P.PROGRAMS["binomial"](**kw)
    devices = fleet()
    powers = probe(prog, devices)
    G = prog.total_work
    with EngineSession(devices) as session:
        session.register_workload(prog)
        for off, size in ((G // 2, G // 4), (G // 8, G // 4)):
            reset_counts()
            roi = Region.line(size, offset=off)
            res = session.submit(prog, region=roi, mode=OffloadMode.ROI,
                                 powers=powers).result()
            n_launch = KB.launches
            check_group(res, devices, "binomial ROI", ["binomial"])
            want = outputs["binomial"][off * 128:(off + size) * 128]
            np.testing.assert_allclose(res.output, want, rtol=1e-4,
                                       atol=1e-3)
            log(f"ROI binomial [{off}, {off + size}) of {G}: roi "
                f"{res.total_time:.3f} s, init {res.phases.init_s:.4f} s, "
                f"launches {n_launch}")

    # ---------------------------------- kernels against plain versions
    records = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, ops,
               library_ms, shape):
        b_ms, b_by = bound(nbytes, ops)
        rec = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=launches[name], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, shape=shape)
        records.append(rec)
        log(f"kernel {name} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" bound {b_ms:.4f} ms ({b_by}), library {library_ms}, max "
            f"abs err {err:.3g}")

    # gaussian: the largest packet on the card, whole
    kw = sizes["gaussian"]
    rng = np.random.default_rng(0)
    img = rng.standard_normal((kw["h"], kw["w"])).astype(np.float32)
    from repro_torch.kernels.gaussian import ops as gops
    ip, wts = gops.prepare(img)
    ipd, wd = torch.from_numpy(ip).to(dev0), torch.from_numpy(wts).to(dev0)
    off, size = largest["gaussian"]
    r0, nr = off * gops.LWS, size * gops.LWS
    got = KG.blur_rows(ipd, wd, r0, nr)
    want = RG.blur_rows_ref(ipd, wd, r0, nr)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["gaussian"][0],
                               atol=TOLERANCES["gaussian"][1])
    err = float((got - want).abs().max())
    K = wts.shape[0]
    band = ipd[r0:r0 + nr + K - 1][None, None]
    w2 = (wd[:, None] * wd[None, :])[None, None]
    lib_out = torch.nn.functional.conv2d(band, w2)[0, 0]
    log(f"  conv2d vs kernel max abs diff "
        f"{float((lib_out - got).abs().max()):.3g}")
    Wp = ip.shape[1]
    W = Wp - (K - 1)
    record("gaussian", "src/repro_torch/csrc/gaussian.cu",
           "src/repro/kernels/gaussian/kernel.py:36", err,
           cuda_ms(lambda: KG.blur_rows(ipd, wd, r0, nr), torch),
           cuda_ms(lambda: RG.blur_rows_ref(ipd, wd, r0, nr), torch, 2),
           4.0 * ((nr + K - 1) * Wp + nr * W + K),
           2.0 * K * nr * (Wp + W),
           cuda_ms(lambda: torch.nn.functional.conv2d(band, w2), torch),
           f"rows {nr} of the padded {ip.shape} image (largest packet)")
    del ipd, band, got, want, lib_out

    # binomial: the largest packet on the card (at most 2**21 options:
    # the plain version holds several (n, 255) planes)
    from repro_torch.kernels.binomial import ops as bops
    s0, k0, ty = (torch.from_numpy(x).to(dev0)
                  for x in bops.make_inputs(sizes["binomial"]["n_options"]))
    off, size = largest["binomial"]
    a = off * bops.LWS
    n = min(size * bops.LWS, 1 << 21)
    args_b = (s0[a:a + n], k0[a:a + n], ty[a:a + n])
    got = KB.price_options(*args_b)
    want = RB.price_options(*args_b)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["binomial"][0],
                               atol=TOLERANCES["binomial"][1])
    steps = RB.STEPS
    record("binomial", "src/repro_torch/csrc/binomial.cu",
           "src/repro/kernels/binomial/kernel.py:42",
           float((got - want).abs().max()),
           cuda_ms(lambda: KB.price_options(*args_b), torch),
           cuda_ms(lambda: RB.price_options(*args_b), torch, 2),
           16.0 * n,
           n * (4.0 * steps * (steps + 1) / 2 + 6.0 * (steps + 1) + 12),
           None,
           f"{n} options of the largest packet ({size * bops.LWS})")
    del s0, k0, ty

    # mandelbrot: a 64-row band of the largest packet, nearest the centre
    kw = sizes["mandelbrot"]
    px, iters = kw["px"], kw["max_iter"]
    from repro_torch.kernels.mandelbrot import ops as mops
    off, size = largest["mandelbrot"]
    lo, hi = off * mops.LWS, (off + size) * mops.LWS
    nr = min(64, hi - lo)
    r0 = min(max(px // 2 - nr // 2, lo), hi - nr)
    got = KM.escape_counts(r0, nr, px, px, iters, device=dev0)
    want = RM.escape_counts(r0, nr, px, px, iters, device=dev0)
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"mandelbrot kernel: {n_bad} counts differ")
    iters_done = float(got.sum())
    record("mandelbrot", "src/repro_torch/csrc/mandelbrot.cu",
           "src/repro/kernels/mandelbrot/kernel.py:49", 0.0,
           cuda_ms(lambda: KM.escape_counts(r0, nr, px, px, iters,
                                            device=dev0), torch),
           cuda_ms(lambda: RM.escape_counts(r0, nr, px, px, iters,
                                            device=dev0), torch, 1),
           4.0 * nr * px, 8.0 * iters_done + 6.0 * nr * px, None,
           f"rows [{r0}, {r0 + nr}) x {px} of the largest packet "
           f"(rows [{lo}, {hi})), {iters_done:.0f} iterations")

    # nbody: the largest packet on the card (at most 2**17 targets),
    # against all sources
    from repro_torch.kernels.nbody import ops as nops
    pm_np, vel_np = nops.make_inputs(sizes["nbody"]["n_bodies"])
    pm = torch.from_numpy(pm_np).to(dev0)
    vel = torch.from_numpy(vel_np).to(dev0)
    N = pm.shape[0]
    off, size = largest["nbody"]
    t0n = off * nops.LWS
    nt = min(size * nops.LWS, 1 << 17)
    got = KN.step_rows(pm, vel, t0n, nt)
    want = RN.step_rows(pm, vel, t0n, nt)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["nbody"][0],
                               atol=TOLERANCES["nbody"][1])
    # the sum over N sources runs in another order in the kernel (one
    # running sum per target) than in the plain version (torch's
    # reduction): measure both against float64 on a subset of targets
    sub = slice(0, min(nt, 256))
    pm64 = pm.double()
    acc64 = RN.accelerations(pm64, t0n, sub.stop)     # pow(-1.5) form
    v0 = vel[t0n:t0n + sub.stop].double()
    rel = {}
    for label, rows in (("kernel", got), ("plain", want)):
        acc = (rows[sub, 4:7].double() - v0) / RN.DT
        rel[label] = float(((acc - acc64).norm(dim=1)
                            / acc64.norm(dim=1)).max())
    log(f"  nbody |acc - acc_f64| / |acc_f64| over {sub.stop} targets: "
        f"kernel {rel['kernel']:.3g}, plain {rel['plain']:.3g}")
    record("nbody", "src/repro_torch/csrc/nbody.cu",
           "src/repro/kernels/nbody/kernel.py:38",
           float((got - want).abs().max()),
           cuda_ms(lambda: KN.step_rows(pm, vel, t0n, nt), torch),
           cuda_ms(lambda: RN.step_rows(pm, vel, t0n, nt), torch, 2),
           16.0 * N + 12.0 * nt + 28.0 * nt, 20.0 * nt * N + 15.0 * nt,
           None,
           f"{nt} targets of the largest packet ({size * nops.LWS}) x "
           f"{N} sources")

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
