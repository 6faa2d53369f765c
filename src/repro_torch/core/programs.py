"""Program adapters: wrap the kernel suite's range entry points as
co-execution Programs (real execution on torch devices).

The four 1-D adapters (``run_range``) of the paper's kernel programs — a
flat work-group line, one work-group = ``LWS`` rows/options/bodies.  Each
build stages the inputs on the group's device (``DeviceGroup.put``); the
range function then returns the packet's rows on that device, computed by
the hand-written kernel on a card and by the plain version on the CPU.

Default sizes are small so the CPU tests stay fast; the paper's sizes are
in each ``kernels/*/ref.py`` docstring."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.core.runtime import Program
from repro_torch.kernels.binomial import ops as binomial_ops
from repro_torch.kernels.gaussian import ops as gaussian_ops
from repro_torch.kernels.mandelbrot import ops as mandelbrot_ops
from repro_torch.kernels.nbody import ops as nbody_ops


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


PROGRAMS = {
    "gaussian": gaussian_program,
    "binomial": binomial_program,
    "mandelbrot": mandelbrot_program,
    "nbody": nbody_program,
}


def reference_output(program_name: str, device="cuda",
                     **kwargs) -> np.ndarray:
    """Single-device single-packet execution (the correctness oracle for
    co-executed outputs), returned as a host array.

    Runs on the card (``device="cuda"``) by default, where one launch of
    the program's kernel covers the whole range; ``device="cpu"`` runs the
    plain version on the host.  Raises ``RuntimeError`` when the card is
    asked for and CUDA is unavailable: it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"reference_output({program_name!r}): CUDA is unavailable; "
            "pass device='cpu' to run the plain version on the host")
    prog = PROGRAMS[program_name](**kwargs)
    group = DeviceGroup("reference", device=device)
    out, _ = group.run_packet(prog.build(group), 0, prog.total_work)
    out = out.detach().cpu().numpy()
    return out.reshape(prog.total_work * prog.out_rows_per_wg, prog.out_cols)
