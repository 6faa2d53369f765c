"""Wrapper of the hand-written CUDA binomial kernel (``csrc/binomial.cu``,
one CTA per option), which replaces the JAX package's Pallas kernel
``kernels/binomial/kernel.py`` ``price_options``.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.binomial import ref as R

launches = 0


def price_options(s0, strike, t_years, *, steps: int = R.STEPS):
    """(n,) float32 s0/strike/t_years -> (n,) option values.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    global launches
    if s0.device.type == "cpu":
        return R.price_options(s0, strike, t_years, steps=steps)
    for name, t in (("s0", s0), ("strike", strike), ("t_years", t_years)):
        build.check_cuda(f"price_options {name}", t, torch.float32, 1)
        if t.shape != s0.shape or t.device != s0.device:
            raise ValueError(f"price_options: {name} does not match s0")
    if not 1 <= steps < 256:
        raise ValueError(f"price_options: steps must be in [1, 255], "
                         f"got {steps}")
    out = torch.empty_like(s0)
    build.launch("binomial_price", s0, s0.data_ptr(), strike.data_ptr(),
                 t_years.data_ptr(), out.data_ptr(), s0.numel(), steps)
    launches += 1
    return out
