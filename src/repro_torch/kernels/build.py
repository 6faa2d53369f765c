"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into an
object, all sources at once in parallel, and the objects are linked into
one shared library with a plain C interface that ``ctypes`` loads.  The
build happens at first use, under a lock (threads and processes), into
``build/repro_torch/`` at the checkout's root; the library's name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.  Nothing
here runs at import: the CPU tests import every module on a host without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source flags: Mandelbrot's escape counts are compared exactly, so its
# source must not contract a*b+c into one rounding (it also spells every
# operation with an _rn intrinsic, which nvcc never contracts)
SOURCE_FLAGS = {"mandelbrot.cu": ["-fmad=false"]}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: argument types (every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints); all return int
PROTOTYPES = {
    "binomial_price": [_P, _P, _P, _P, _I, _I, _P],
    "mandelbrot_counts": [_P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gaussian_blur_rows": [_P, _P, _P] + [_I] * 7 + [_P],
    "nbody_step": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "flash_attention_fwd": [_P] * 5 + [_I] * 9 + [_P],
    "flash_attention_bwd": [_P] * 10 + [_I] * 8 + [_P],
    "flash_decode_fwd": [_P] * 8 + [_I] * 11 + [_P],
    "selective_scan_fwd": [_P] * 7 + [_I] * 4 + [_P],
    "selective_scan_bwd": [_P] * 11 + [_I] * 4 + [_LL, _P],
    "selective_scan_fused_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "selective_scan_fused_bwd": [_P] * 15 + [_I] * 5 + [_LL, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# wall seconds the last load() spent building (0.0 when it found the
# library already built) and the compiler's resource report per source
build_seconds: float = 0.0
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built with the CUDA toolkit's nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(p.name, [])).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{out.stem}.{src.stem}.o")
        cmd = [nvcc, *ARCH, *FLAGS, *SOURCE_FLAGS.get(src.name, []),
               "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        ptxas_report[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load_library(out: Path, lock_path: Path, compile_fn,
                 prototypes) -> ctypes.CDLL:
    """Load the shared library ``out``, first running ``compile_fn(out)``
    under the file lock ``lock_path`` (another process building it waits)
    if it is not built yet; every entry point of ``prototypes`` returns
    int."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not out.exists():
                compile_fn(out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in prototypes.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_library(BUILD_DIR / f"libreprotorch_{_digest()}.so",
                           BUILD_DIR / "lock", _compile, PROTOTYPES)
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, on, *args) -> None:
    """Launch C entry point ``name`` on PyTorch's current stream of the
    card that holds tensor ``on``; raise if CUDA reports an error."""
    import torch
    lib = load()
    with torch.cuda.device(on.device):
        stream = torch.cuda.current_stream(on.device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def tally(table: dict, name: str, flops: float, nbytes: float, *,
          dot_flops: float = 0.0, transcendentals: float = 0.0) -> None:
    """Add one call's work to ``table[name]`` (a wrapper's ``meta_cost``,
    kept as its ``launches`` is): what a wrapper given ``meta`` tensors
    records where a CUDA call would launch, by the formulas of the
    kernel's bound (its least operations and bytes)."""
    t = table.setdefault(name, dict(calls=0, flops=0.0, dot_flops=0.0,
                                    transcendentals=0.0, bytes=0.0))
    t["calls"] += 1
    t["flops"] += flops
    t["dot_flops"] += dot_flops
    t["transcendentals"] += transcendentals
    t["bytes"] += nbytes


def check_cuda(name: str, t, dtype, ndim: int, meta_ok: bool = False
               ) -> None:
    """A wrapper's argument check: raise on what the kernel does not
    take (a tensor off the card, another dtype or rank, a strided view).
    With ``meta_ok`` a ``meta`` tensor passes too: it stands for a card's
    tensor in a plan, which the wrapper answers without a launch
    (:func:`tally`)."""
    if t.device.type != "cuda" and not (meta_ok and t.device.type == "meta"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
