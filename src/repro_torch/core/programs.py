"""Program adapters: wrap the kernel suite's range entry points as
co-execution Programs (real execution on torch devices).

Two geometries:

* the classic 1-D adapters (``run_range``) — a flat work-group line, one
  work-group = ``LWS`` rows/options/bodies/pixel rows;
* 2-D NDRange adapters (``*_program_2d``, image kernels only) — the
  Program's region is ``rows x cols`` with per-dimension lws, the build
  produces a ``fn(row0, n_rows, col0, n_cols)`` tile kernel, and
  schedulers carve row panels.  These are the ROI-offloading targets
  (register once, re-submit sub-regions warm).

Each build stages the inputs on the group's device (``DeviceGroup.put``);
the range function then returns the packet's rows or tile on that device,
computed by the hand-written kernel on a card and by the plain version on
the CPU (ray: plain PyTorch ops on both).

Default sizes are small so the CPU tests stay fast; the paper's sizes are
in each ``kernels/*/ref.py`` docstring."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.core.region import Region
from repro_torch.core.runtime import Program
from repro_torch.kernels.binomial import ops as binomial_ops
from repro_torch.kernels.gaussian import ops as gaussian_ops
from repro_torch.kernels.mandelbrot import ops as mandelbrot_ops
from repro_torch.kernels.nbody import ops as nbody_ops
from repro_torch.kernels.ray import ops as ray_ops
from repro_torch.kernels.ray import ref as ray_ref


def gaussian_program(h: int = 1024, w: int = 512, seed: int = 0) -> Program:
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    ip, wts = gaussian_ops.prepare(img)
    G = gaussian_ops.total_work(img)

    def build(dev):
        ipd = dev.put(ip)
        wd = dev.put(wts)

        def fn(offset, size):
            return gaussian_ops.run_range(ipd, wd, offset, size)
        return fn

    return Program("gaussian", G, 1, build,
                   out_rows_per_wg=gaussian_ops.LWS, out_cols=w,
                   in_bytes=ip.nbytes + wts.nbytes)


def gaussian_program_2d(h: int = 512, w: int = 512, seed: int = 0,
                        lws: Tuple[int, int] = (32, 32)) -> Program:
    """Gaussian blur as a 2-D NDRange (rows x cols, row-panel carving)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    ip, wts = gaussian_ops.prepare(img)

    def build(dev):
        ipd = dev.put(ip)
        wd = dev.put(wts)

        def fn(row0, n_rows, col0, n_cols):
            return gaussian_ops.run_region(ipd, wd, row0, n_rows,
                                           col0, n_cols)
        return fn

    return Program("gaussian2d", build=build,
                   region=Region.rect(h, w, lws=lws),
                   in_bytes=ip.nbytes + wts.nbytes)


def mandelbrot_program_2d(px: int = 256, max_iter: int = 256,
                          lws: Tuple[int, int] = (8, 8)) -> Program:
    def build(dev):
        def fn(row0, n_rows, col0, n_cols):
            return mandelbrot_ops.run_region(row0, n_rows, col0, n_cols,
                                             width=px, height=px,
                                             max_iter=max_iter,
                                             device=dev.device)
        return fn

    return Program("mandelbrot2d", build=build,
                   region=Region.rect(px, px, lws=lws),
                   out_dtype=np.int32)


def ray_program_2d(which: int = 1, px: int = 256,
                   lws: Tuple[int, int] = (4, 4)) -> Program:
    scene = ray_ref.make_scene(which)

    def build(dev):
        sc = {k: dev.put(v) for k, v in scene.items()}
        ax = {k: dev.put(v) for k, v in ray_ref.pixel_axes(px, px).items()}

        def fn(row0, n_rows, col0, n_cols):
            return ray_ops.run_region(sc, row0, n_rows, col0, n_cols,
                                      width=px, height=px, axes=ax)
        return fn

    return Program(f"ray{which}_2d", build=build,
                   region=Region.rect(px, px, lws=lws), out_cols=3,
                   in_bytes=sum(v.nbytes for v in scene.values()))


def binomial_program(n_options: int = 65536, seed: int = 0) -> Program:
    s0, k0, ty = binomial_ops.make_inputs(n_options, seed)
    G = binomial_ops.total_work(n_options)

    def build(dev):
        a, b, c = (dev.put(x) for x in (s0, k0, ty))

        def fn(offset, size):
            return binomial_ops.run_range(a, b, c, offset, size)
        return fn

    return Program("binomial", G, 1, build,
                   out_rows_per_wg=binomial_ops.LWS, out_cols=1,
                   in_bytes=s0.nbytes + k0.nbytes + ty.nbytes)


def mandelbrot_program(px: int = 512, max_iter: int = 256) -> Program:
    G = mandelbrot_ops.total_work(px)

    def build(dev):
        def fn(offset, size):
            return mandelbrot_ops.run_range(
                offset, size, width=px, height=px, max_iter=max_iter,
                device=dev.device)
        return fn

    return Program("mandelbrot", G, 1, build,
                   out_rows_per_wg=mandelbrot_ops.LWS * px, out_cols=1,
                   out_dtype=np.int32)


def nbody_program(n_bodies: int = 8192, seed: int = 0) -> Program:
    pm, vel = nbody_ops.make_inputs(n_bodies, seed)
    G = nbody_ops.total_work(n_bodies)

    def build(dev):
        pmd = dev.put(pm)
        vd = dev.put(vel)

        def fn(offset, size):
            return nbody_ops.run_range(pmd, vd, offset, size)
        return fn

    return Program("nbody", G, 1, build,
                   out_rows_per_wg=nbody_ops.LWS, out_cols=7,
                   in_bytes=pm.nbytes + vel.nbytes)


def ray_program(which: int = 1, px: int = 256) -> Program:
    scene = ray_ref.make_scene(which)
    G = ray_ops.total_work(px)

    def build(dev):
        sc = {k: dev.put(v) for k, v in scene.items()}
        ax = {k: dev.put(v) for k, v in ray_ref.pixel_axes(px, px).items()}

        def fn(offset, size):
            img = ray_ops.run_range(sc, offset, size, width=px, height=px,
                                    axes=ax)
            return img.reshape(-1, 3)
        return fn

    return Program(f"ray{which}", G, 1, build,
                   out_rows_per_wg=ray_ops.LWS * px, out_cols=3,
                   in_bytes=sum(v.nbytes for v in scene.values()))


PROGRAMS = {
    "gaussian": gaussian_program,
    "binomial": binomial_program,
    "mandelbrot": mandelbrot_program,
    "nbody": nbody_program,
    "ray1": lambda **kw: ray_program(1, **kw),
    "ray2": lambda **kw: ray_program(2, **kw),
    # 2-D NDRange variants (ROI-offloading targets, row-panel carving)
    "gaussian2d": gaussian_program_2d,
    "mandelbrot2d": mandelbrot_program_2d,
    "ray1_2d": lambda **kw: ray_program_2d(1, **kw),
    "ray2_2d": lambda **kw: ray_program_2d(2, **kw),
}


def reference_output(program_name: str, device="cuda",
                     **kwargs) -> np.ndarray:
    """Single-device single-packet execution (the correctness oracle for
    co-executed outputs), returned as a host array.

    Runs on the card (``device="cuda"``) by default, where one launch of
    the program's kernel covers the whole range; ``device="cpu"`` runs the
    plain version on the host.  2-D programs return (rows, cols*out_cols).
    Raises ``RuntimeError`` when the card is asked for and CUDA is
    unavailable: it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"reference_output({program_name!r}): CUDA is unavailable; "
            "pass device='cpu' to run the plain version on the host")
    prog = PROGRAMS[program_name](**kwargs)
    group = DeviceGroup("reference", device=device)
    fn = prog.build(group)
    region = prog.work_region
    if region.ndim == 2:
        # one tile over the whole NDRange, called as the runtime calls it
        d0, d1 = region.dims
        out, _ = group.run_packet(
            lambda _o, _s: fn(d0.offset, d0.size, d1.offset, d1.size),
            0, d0.size)
        return out.detach().cpu().numpy().reshape(
            d0.size * prog.out_rows_per_wg, d1.size * prog.out_cols)
    out, _ = group.run_packet(fn, 0, prog.total_work)
    out = out.detach().cpu().numpy()
    return out.reshape(prog.total_work * prog.out_rows_per_wg, prog.out_cols)
