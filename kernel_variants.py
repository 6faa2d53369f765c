#!/usr/bin/env python3
"""Time other shapes of the binomial, N-body, Mandelbrot and Gaussian CUDA
kernels on one card.

    python3 kernel_variants.py                    # the default variants
    python3 kernel_variants.py --kernels mandelbrot,gaussian --sass
    python3 kernel_variants.py --binomial 254,8 --nbody 8,4,128,2,3 \\
        --mandelbrot 16 --gaussian 31,40,20,10,2

A variant is the template arguments of a kernel's ``launch`` helper in its
source, under ``src/repro_torch/csrc/``: ``launch<kSteps, K>`` of
``binomial.cu`` (kSteps = 254: the step counts are compile-time, 0: read
at run time; K steps a pass over the lattice), ``launch<kWarps, kPerLane,
kTile, kStages, kMinBlocks>`` of ``nbody.cu``, ``launch<U>`` of
``mandelbrot.cu`` (U iterations a block) and ``launch<kTaps, kRows,
kRowsPerThread, kWarps, kMinBlocks>`` of ``gaussian.cu`` (kTaps = 31:
compile-time taps, 0: the run-time-K instance).  The first variant of each
kernel should be the shape its C entry point launches.

For each source the script writes a wrapper that includes it and exports
one C function per variant, builds all of them with the flags of
``repro_torch.kernels.build`` for ``sm_90a`` (the compiler's register
and spill lines are printed), holds every variant against the plain
version (``chip_smoke.py``'s tolerances, Mandelbrot exactly; nbody also
against float64 on 256 targets) and then times the variants in turns,
``--rounds`` times, at ``chip_smoke.py``'s timed shapes: 2**21 options of
254 steps; 114,688 targets and the smallest card packet (1,600 targets)
against 229,376 sources; the 64 rows at the centre of the 14,336-px
Mandelbrot image (held against the plain version) and the whole image
(held against the first variant), at 5,000 iterations; 4,096 rows and
the smallest card packet (128 rows) of the 8,222-px padded Gaussian
image, 31 taps.  Each line gives the median over the rounds beside the
bound that ``chip_smoke.py`` computes.  ``--sass`` prints each
variant's SASS mix (``cuobjdump``), the instructions per iteration of
each Mandelbrot loop and the Gaussian kernels' shared-memory loads per
output pixel.  Exits non-zero without a card or if a variant does not
build or disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

DEFAULTS = {
    "binomial": ["254,8", "0,8", "254,1", "254,2", "254,4"],
    "nbody": ["8,4,128,2,3", "8,4,128,2,4", "8,2,128,2,3", "8,8,64,2,2",
              "16,2,64,2,2", "8,4,64,3,3", "4,4,128,2,6"],
    "mandelbrot": ["16", "1", "4", "8", "32"],
    "gaussian": ["31,40,40,5,4", "0,40,40,5,4", "31,40,40,5,3",
                 "31,40,20,10,2", "31,40,20,10,3", "31,20,20,5,6",
                 "31,60,60,5,3"],
}
# the timed shapes of chip_smoke.py phase 5 at the paper's sizes
N_OPTIONS = 1 << 21
N_TARGETS = (114688, 1600)
MANDEL_ROWS = 64
GAUSS_ROWS = (4096, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the kernels' entry points
ARGTYPES = {
    "binomial": [_P] * 4 + [_I] * 2 + [_P],
    "nbody": [_P] * 3 + [_I] * 3 + [_F] * 2 + [_P],
    "mandelbrot": [_P] + [_I] * 7 + [_P],
    "gaussian": [_P] * 3 + [_I] * 6 + [_P],
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
    "mandelbrot": (
        'extern "C" int {name}(int* out, int row0, int n_rows, int col0, '
        "int n_cols, int width, int height, int max_iter, void* s) {{\n"
        "  return static_cast<int>(launch<{args}>(out, row0, n_rows, col0, "
        "n_cols, width, height, max_iter, static_cast<cudaStream_t>(s)));"
        "\n}}\n"),
    "gaussian": (
        'extern "C" int {name}(const float* img, const float* w, float* out, '
        "int row0, int n_rows, int col0, int n_cols, int wp, int K, "
        "void* s) {{\n"
        "  return static_cast<int>(launch<{args}>(img, w, out, row0, n_rows, "
        "col0, n_cols, wp, K, static_cast<cudaStream_t>(s)));\n}}\n"),
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


_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass(obj: Path) -> dict:
    """{kernel function: [(address, opcode, instruction text)]} from
    ``cuobjdump -sass``."""
    from repro_torch.kernels import build as B
    cuobjdump = Path(B._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _LINE.search(line)
        if cur is None or not m:
            continue
        body = m.group(2)
        if body.startswith("@"):
            body = body.split(None, 1)[1]
        cur.append((int(m.group(1), 16), body.split()[0].split(".")[0],
                    body))
    return funcs


def print_mix(funcs: dict) -> None:
    """Each function's SASS instruction count and most frequent opcodes.
    Where every loop of a function is unrolled (binomial's phases at
    kSteps = 254), the count is what one warp executes."""
    for func, ins in funcs.items():
        mix = {}
        for _, op, _ in ins:
            mix[op] = mix.get(op, 0) + 1
        top = sorted(mix.items(), key=lambda kv: -kv[1])[:12]
        print(f"sass {func}: {len(ins)} instructions; "
              + ", ".join(f"{op} {n}" for op, n in top))


def loops(ins) -> list:
    """(start, end, instructions) of each loop: the span from a backward
    branch's target to the branch."""
    out = []
    for addr, op, text in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            out.append((lo, addr, [i for i in ins if lo <= i[0] <= addr]))
    return out


def mandelbrot_loops(funcs: dict) -> None:
    """Instructions per iteration of each loop of each Mandelbrot kernel:
    the loop's instructions over its FFMAs (one FFMA an iteration, zi')."""
    for func, ins in funcs.items():
        for lo, hi, body in loops(ins):
            n_ffma = sum(1 for _, op, _ in body if op == "FFMA")
            ops = {}
            for _, op, _ in body:
                ops[op] = ops.get(op, 0) + 1
            per = f"{len(body) / n_ffma:.2f}" if n_ffma else "n/a"
            print(f"sass loop {func} [{lo:#x}, {hi:#x}]: {len(body)} "
                  f"instructions, {n_ffma} iterations, {per} an iteration; "
                  + ", ".join(f"{op} {n}" for op, n in sorted(
                      ops.items(), key=lambda kv: -kv[1])))


def gaussian_lds(funcs: dict, variants) -> None:
    """Shared-memory loads per output pixel of each compile-time-tap
    Gaussian kernel on a whole tile, where every loop is unrolled and each
    LDS in the SASS runs once a thread: LDS x threads / (kRows x 128)."""
    for a in variants:
        taps, rows, _, warps, _ = map(int, a.split(","))
        mangled = "I" + "".join(f"Li{n}E" for n in a.split(",")) + "E"
        func = next((f for f in funcs
                     if "gaussian_kernel" in f and mangled in f), None)
        if func is None:
            print(f"sass gaussian<{a}>: kernel not found")
            continue
        n_lds = sum(1 for _, op, _ in funcs[func] if op == "LDS")
        if taps == 0:
            print(f"sass gaussian<{a}>: {n_lds} LDS (loops over a run-time "
                  f"K: not a count per pixel)")
            continue
        per_px = n_lds * 32 * warps / (rows * 128)
        print(f"sass gaussian<{a}>: {n_lds} LDS, {per_px:.3f} per output "
              f"pixel of a whole tile")


def call(torch, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")


def add_binomial(torch, lib, dev, arg_list, runs) -> None:
    from repro_torch.kernels.binomial import ops as bops
    from repro_torch.kernels.binomial import ref as RB
    steps = RB.STEPS
    s0, k0, ty = (torch.from_numpy(x).to(dev)
                  for x in bops.make_inputs(N_OPTIONS))
    b_ms, _ = CS.bound(16.0 * N_OPTIONS, CS.binomial_ops(N_OPTIONS, steps))
    sub = tuple(x[:4096] for x in (s0, k0, ty))
    want = RB.price_options(*sub)
    for a in arg_list:
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


def add_nbody(torch, lib, dev, arg_list, runs) -> None:
    from repro_torch.kernels.nbody import ops as nops
    from repro_torch.kernels.nbody import ref as RN
    pm_np, vel_np = nops.make_inputs(CS.PAPER_SIZES["nbody"]["n_bodies"])
    pm, vel = torch.from_numpy(pm_np).to(dev), torch.from_numpy(vel_np).to(dev)
    N = pm.shape[0]
    want = RN.step_rows(pm, vel, 0, 320)
    acc64 = RN.accelerations(pm.double(), 0, 256)
    for a in arg_list:
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


def add_mandelbrot(torch, lib, dev, arg_list, runs) -> None:
    """The band at the centre, held against the plain version, and the
    whole image, each variant's counts held against the first's."""
    from repro_torch.kernels.mandelbrot import ref as RM
    kw = CS.PAPER_SIZES["mandelbrot"]
    px, iters = kw["px"], kw["max_iter"]
    r0 = px // 2 - MANDEL_ROWS // 2
    want = RM.escape_counts(r0, MANDEL_ROWS, px, px, iters, device=dev)
    first = None
    for a in arg_list:
        fn = getattr(lib, symbol("mandelbrot", a))
        for row0, n in ((r0, MANDEL_ROWS), (0, px)):
            args = (row0, n, 0, px, px, px, iters)
            out = torch.empty((n, px), dtype=torch.int32, device=dev)
            call(torch, fn, out.data_ptr(), *args)
            ref = want if n == MANDEL_ROWS else first
            if ref is None:
                first = ref = out
            n_bad = int((out != ref).sum())
            if n_bad:
                raise RuntimeError(f"mandelbrot<{a}>: {n_bad} counts differ "
                                   f"on {n} rows")
            done = float(out.sum())
            b_ms, _ = CS.bound(4.0 * n * px, 8.0 * done + 6.0 * n * px)
            runs[f"mandelbrot<{a}> rows [{row0}, {row0 + n}), {done:.0f} "
                 f"iterations"] = (
                lambda fn=fn, out=out, args=args: call(
                    torch, fn, out.data_ptr(), *args), b_ms)


def add_gaussian(torch, lib, dev, arg_list, runs) -> None:
    import numpy as np
    from repro_torch.kernels.gaussian import ops as gops
    from repro_torch.kernels.gaussian import ref as RG
    kw = CS.PAPER_SIZES["gaussian"]
    img = np.random.default_rng(0).standard_normal(
        (kw["h"], kw["w"])).astype(np.float32)
    ip, wts = (torch.from_numpy(x).to(dev) for x in gops.prepare(img))
    Hp, Wp = ip.shape
    K = wts.shape[0]
    W = Wp - (K - 1)
    shapes = [(kw["h"] // 2 - n // 2, n) for n in GAUSS_ROWS]
    wants = {n: RG.blur_rows_ref(ip, wts, r0, n) for r0, n in shapes}
    for a in arg_list:
        fn = getattr(lib, symbol("gaussian", a))
        for r0, n in shapes:
            out = torch.empty((n, W), device=dev)
            call(torch, fn, ip.data_ptr(), wts.data_ptr(), out.data_ptr(),
                 r0, n, 0, W, Wp, K)
            torch.testing.assert_close(out, wants[n],
                                       rtol=CS.TOLERANCES["gaussian"][0],
                                       atol=CS.TOLERANCES["gaussian"][1])
            b_ms, _ = CS.bound(4.0 * ((n + K - 1) * Wp + n * W + K),
                               2.0 * K * n * (Wp + W))
            runs[f"gaussian<{a}> {n} rows"] = (
                lambda fn=fn, out=out, r0=r0, n=n: call(
                    torch, fn, ip.data_ptr(), wts.data_ptr(), out.data_ptr(),
                    r0, n, 0, W, Wp, K), b_ms)


ADD = {"binomial": add_binomial, "nbody": add_nbody,
       "mandelbrot": add_mandelbrot, "gaussian": add_gaussian}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(DEFAULTS),
                    help="comma-separated kernels to build and time")
    ap.add_argument("--binomial", action="append", metavar="KSTEPS,K")
    ap.add_argument("--nbody", action="append",
                    metavar="WARPS,PERLANE,TILE,STAGES,MINBLOCKS")
    ap.add_argument("--mandelbrot", action="append", metavar="U")
    ap.add_argument("--gaussian", action="append",
                    metavar="TAPS,ROWS,ROWSPERTHREAD,WARPS,MINBLOCKS")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", action="store_true",
                    help="print each variant's SASS instruction mix")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = {k: getattr(args, k) or DEFAULTS[k]
                for k in args.kernels.split(",")}
    lib = build(variants)
    if args.sass:
        from repro_torch.kernels import build as B
        for kernel in variants:
            funcs = sass(B.BUILD_DIR.parent / "variants"
                         / f"{kernel}_variants.o")
            print_mix(funcs)
            if kernel == "mandelbrot":
                mandelbrot_loops(funcs)
            elif kernel == "gaussian":
                gaussian_lds(funcs, variants[kernel])
    dev = torch.device("cuda:0")
    runs = {}    # label -> (thunk, bound ms)
    for kernel, arg_list in variants.items():
        ADD[kernel](torch, lib, dev, arg_list, runs)

    timed = {}   # label -> [ms per round]
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
