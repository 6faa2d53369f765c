"""Build and load the compiled C++ host routines of ``repro_torch/csrc/host``.

The host CPU group of a co-execution runs these, as the JAX package's CPU
group runs compiled code (each program's range entry there is ``jax.jit``
of its oracle, run by XLA:CPU).  Every ``csrc/host/*.cpp`` is compiled by
``g++`` into an object, all sources at once in parallel, and the objects
are linked into one shared library with a plain C interface that
``ctypes`` loads.  As on the CUDA route (``build.py``), the build happens
at first use, under a lock (threads and processes), into
``build/repro_torch/``; the library's name carries a hash of the sources,
the flags and the host CPU's model and flags, since ``-march=native`` code
must not be loaded on another CPU that shares the checkout.

The flags keep IEEE arithmetic: no ``-ffast-math``, and ``-ffp-contract=off``
so that no ``a * b + c`` becomes one rounding (Mandelbrot's counts and the
ray tracer's pixels are compared exactly).  ``-fno-math-errno`` changes no
value: ``errno`` is never read, and without it ``sqrtf`` keeps a branch to
the library that stops a loop from being vectorised.

Each C entry point returns 0 or an error status; :func:`call` raises when
it is not 0.  ``ctypes.CDLL`` releases the interpreter lock for the call,
so a card's feeder thread goes on launching while the host computes.
There is no fallback: without ``g++`` the first call raises.  Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import BUILD_DIR, CSRC

HOST_CSRC = CSRC / "host"
FLAGS = ["-std=c++17", "-O3", "-march=native", "-ffp-contract=off",
         "-fno-math-errno", "-fPIC", "-pthread"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types (every pointer c_void_p); all return int,
# and each takes the number of threads last
PROTOTYPES = {
    "host_mandelbrot_counts": [_P, _P, _P, _I, _I, _I, _I],
    "host_gaussian_blur_rows": [_P, _P, _P] + [_I] * 8,
    "host_binomial_price": [_P, _P, _P, _P, _I, _I, _I],
    "host_nbody_step": [_P, _P, _P, _I, _I, _I, _F, _F, _I],
    "host_ray_render": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I],
}
# the C entry points' statuses (csrc/host/parallel.h)
STATUS = {1: "bad argument", 2: "a worker failed (out of memory?)"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# wall seconds the last load() spent building (0.0 when it found the
# library already built)
build_seconds: float = 0.0


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host routines of repro_torch "
                           "(csrc/host) are built with g++")
    return found


def cpu_identity() -> str:
    """The host CPU's model and feature flags, from ``/proc/cpuinfo`` (the
    first processor's ``model name`` and ``flags``/``Features`` lines)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine() + " " + platform.processor()
    keep = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags", "Features", "CPU part"):
            keep.setdefault(key, value.strip())
    return "\n".join(f"{k}: {v}" for k, v in sorted(keep.items()))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(cpu_identity().encode())
    for p in sorted(HOST_CSRC.glob("*.[ch]*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_seconds
    gxx = _gxx()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(HOST_CSRC.glob("*.cpp")):
        obj = out.with_name(f"{out.stem}.{src.stem}.o")
        cmd = [gxx, *FLAGS, "-I", str(HOST_CSRC), "-c", str(src), "-o",
               str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    try:
        if failed:
            raise RuntimeError("g++ failed:\n" + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([gxx, *FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"g++ link failed:\n{link.stdout}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The host routines' shared library, built first if its sources,
    flags or host CPU changed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build.load_library(BUILD_DIR / f"host-{_digest()}.so",
                                      BUILD_DIR / "host.lock", _compile,
                                      PROTOTYPES)
        return _lib


def call(name: str, *args) -> None:
    """Run C entry point ``name`` on the host with ``torch``'s intra-op
    thread count (what ``reserve_feeder_cores`` caps); raise if it
    returns a status other than 0."""
    status = getattr(load(), name)(*args, torch.get_num_threads())
    if status:
        raise RuntimeError(f"{name}: status {status} "
                           f"({STATUS.get(status, 'unknown')})")


def check_host(name: str, t, ndim: int) -> None:
    """A host call's argument check: raise ``ValueError`` on what the
    routine does not take (a tensor off the host, another dtype or rank,
    a strided view); nothing is copied to make it fit."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: expected a CPU tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
