#!/usr/bin/env python3
"""Time other shapes of the binomial and N-body CUDA kernels on one card.

    python3 kernel_variants.py                    # the default variants
    python3 kernel_variants.py --binomial 254,8 --binomial 0,8 --nbody 8,4,128,2,3
    python3 kernel_variants.py --sass       # and each variant's SASS mix

A variant is the template arguments of a kernel's ``launch`` helper in its
source: ``launch<kSteps, K>`` of ``src/repro_torch/csrc/binomial.cu``
(kSteps = 254: the step counts are compile-time, 0: read at run time; K
steps a pass over the lattice) and ``launch<kWarps, kPerLane, kTile,
kStages, kMinBlocks>`` of ``src/repro_torch/csrc/nbody.cu``.  The first
variant of each kernel should be the shape its C entry point launches.

For each source the script writes a wrapper that includes it and exports
one C function per variant, builds all of them with the flags of
``repro_torch.kernels.build`` for ``sm_90a`` (the compiler's register
and spill lines are printed), holds every variant against the plain
version (``chip_smoke.py``'s tolerances; nbody also against float64 on
256 targets) and then times the variants in turns, ``--rounds`` times, at
``chip_smoke.py``'s timed shapes: 2**21 options of 254 steps, and 114,688
targets and the smallest card packet (1,600 targets) against 229,376
sources.  Each line gives the median over the rounds beside the bound
that ``chip_smoke.py`` computes.  Exits non-zero without a card or if a
variant does not build or disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

BINOMIAL = ["254,8", "0,8", "254,1", "254,2", "254,4"]
NBODY = ["8,4,128,2,3", "8,4,128,2,4", "8,2,128,2,3", "8,8,64,2,2",
         "16,2,64,2,2", "8,4,64,3,3", "4,4,128,2,6"]
# the timed shapes of chip_smoke.py phase 5 at the paper's sizes
N_OPTIONS = 1 << 21
N_TARGETS = (114688, 1600)
# C signatures of the two kernels' entry points
ARGTYPES = {
    "binomial": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "nbody": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}
WRAPPER = {
    "binomial": (
        'extern "C" int {name}(const float* a, const float* b, '
        "const float* c, float* o, int n, int steps, void* s) {{\n"
        "  return static_cast<int>(launch<{args}>(a, b, c, o, n, steps, "
        "static_cast<cudaStream_t>(s)));\n}}\n"),
    "nbody": (
        'extern "C" int {name}(const float* pm, const float* vel, '
        "float* out, int n, int tgt0, int n_tgt, float eps2, float dt, "
        "void* s) {{\n"
        "  return static_cast<int>(launch<{args}>(pm, vel, out, n, tgt0, "
        "n_tgt, eps2, dt, static_cast<cudaStream_t>(s)));\n}}\n"),
}


def symbol(kernel: str, args: str) -> str:
    return f"{kernel}_" + args.replace(",", "_")


def build(variants: dict) -> ctypes.CDLL:
    """One library with every variant of every kernel; prints ptxas."""
    from repro_torch.kernels import build as B
    out = B.BUILD_DIR.parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = B._nvcc()
    procs, objs = [], []
    for kernel, arg_list in variants.items():
        src = B.CSRC / f"{kernel}.cu"
        body = f'#include "{src}"\n\n' + "".join(
            WRAPPER[kernel].format(name=symbol(kernel, a), args=a)
            for a in arg_list)
        tu = out / f"{kernel}_variants.cu"
        tu.write_text(body)
        obj = tu.with_suffix(".o")
        procs.append((kernel, subprocess.Popen(
            [nvcc, *B.ARCH, *B.FLAGS, *B.SOURCE_FLAGS.get(src.name, []),
             "-I", str(B.CSRC), "-c", str(tu), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    for kernel, proc in procs:
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print(f"{kernel}: {line.strip()}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {kernel}:\n{log}")
    lib_path = out / "libvariants.so"
    subprocess.run([nvcc, *B.ARCH, "-shared", "-o", str(lib_path),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for kernel, arg_list in variants.items():
        for a in arg_list:
            fn = getattr(lib, symbol(kernel, a))
            fn.argtypes, fn.restype = ARGTYPES[kernel], ctypes.c_int
    return lib


def sass_mix(obj: Path) -> None:
    """Print each kernel function's SASS instruction count and its most
    frequent opcodes (``cuobjdump -sass``).  Where every loop of a
    function is unrolled (binomial's phases at kSteps = 254), the count is
    what one warp issues."""
    from repro_torch.kernels import build as B
    cuobjdump = Path(B._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    func, mix = None, {}

    def flush():
        if func is not None:
            top = sorted(mix.items(), key=lambda kv: -kv[1])[:12]
            print(f"sass {func}: {sum(mix.values())} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in top))

    for line in text.splitlines():
        if "Function :" in line:
            flush()
            func, mix = line.split("Function :")[1].strip(), {}
        elif func is not None and line.strip().startswith("/*") \
                and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            op = body.split()[0].rstrip(";")
            mix[op.split(".")[0]] = mix.get(op.split(".")[0], 0) + 1
    flush()


def call(torch, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--binomial", action="append", metavar="KSTEPS,K")
    ap.add_argument("--nbody", action="append",
                    metavar="WARPS,PERLANE,TILE,STAGES,MINBLOCKS")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS instruction mix")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.binomial import ops as bops
    from repro_torch.kernels.binomial import ref as RB
    from repro_torch.kernels.nbody import ops as nops
    from repro_torch.kernels.nbody import ref as RN
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = {"binomial": args.binomial or BINOMIAL,
                "nbody": args.nbody or NBODY}
    lib = build(variants)
    if args.sass:
        from repro_torch.kernels import build as B
        for kernel in variants:
            sass_mix(B.BUILD_DIR.parent / "variants" / f"{kernel}_variants.o")
    dev = torch.device("cuda:0")
    timed = {}   # (label) -> [ms per round]
    runs = {}    # label -> (thunk, bound ms)

    steps = RB.STEPS
    s0, k0, ty = (torch.from_numpy(x).to(dev)
                  for x in bops.make_inputs(N_OPTIONS))
    b_ms, _ = CS.bound(16.0 * N_OPTIONS, CS.binomial_ops(N_OPTIONS, steps))
    sub = tuple(x[:4096] for x in (s0, k0, ty))
    want = RB.price_options(*sub)
    for a in variants["binomial"]:
        fn = getattr(lib, symbol("binomial", a))
        out = torch.empty_like(s0)
        call(torch, fn, sub[0].data_ptr(), sub[1].data_ptr(),
             sub[2].data_ptr(), out.data_ptr(), 4096, steps)
        torch.testing.assert_close(out[:4096], want,
                                   rtol=CS.TOLERANCES["binomial"][0],
                                   atol=CS.TOLERANCES["binomial"][1])
        runs[f"binomial<{a}> {N_OPTIONS} options"] = (
            lambda fn=fn, out=out: call(
                torch, fn, s0.data_ptr(), k0.data_ptr(), ty.data_ptr(),
                out.data_ptr(), N_OPTIONS, steps), b_ms)

    pm_np, vel_np = nops.make_inputs(CS.PAPER_SIZES["nbody"]["n_bodies"])
    pm, vel = torch.from_numpy(pm_np).to(dev), torch.from_numpy(vel_np).to(dev)
    N = pm.shape[0]
    want = RN.step_rows(pm, vel, 0, 320)
    acc64 = RN.accelerations(pm.double(), 0, 256)
    for a in variants["nbody"]:
        fn = getattr(lib, symbol("nbody", a))
        out = torch.empty((max(N_TARGETS), 7), device=dev)
        call(torch, fn, pm.data_ptr(), vel.data_ptr(), out.data_ptr(), N, 0,
             320, RN.EPS2, RN.DT)
        torch.testing.assert_close(out[:320], want,
                                   rtol=CS.TOLERANCES["nbody"][0],
                                   atol=CS.TOLERANCES["nbody"][1])
        acc = (out[:256, 4:7].double() - vel[:256].double()) / RN.DT
        rel = float(((acc - acc64).norm(dim=1) / acc64.norm(dim=1)).max())
        print(f"nbody<{a}>: |acc - acc_f64| / |acc_f64| over 256 targets "
              f"{rel:.3g}")
        for nt in N_TARGETS:
            b_ms, _ = CS.bound(16.0 * N + 40.0 * nt,
                               20.0 * nt * N + 15.0 * nt)
            runs[f"nbody<{a}> {nt} targets"] = (
                lambda fn=fn, out=out, nt=nt: call(
                    torch, fn, pm.data_ptr(), vel.data_ptr(), out.data_ptr(),
                    N, 0, nt, RN.EPS2, RN.DT), b_ms)

    for _ in range(args.rounds):
        for label, (thunk, _) in runs.items():
            timed.setdefault(label, []).append(CS.cuda_ms(thunk, torch))
    for label, (_, b_ms) in runs.items():
        ms = statistics.median(timed[label])
        spread = max(timed[label]) - min(timed[label])
        print(f"{label}: {ms:.4f} ms (spread {spread:.4f} over "
              f"{args.rounds} rounds), bound {b_ms:.4f} ms, "
              f"{b_ms / ms:.1%} of its bound")
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
