"""Wrapper of the hand-written CUDA binomial kernel (``csrc/binomial.cu``,
one warp per option with the lattice in registers), which replaces the JAX
package's Pallas kernel ``kernels/binomial/kernel.py`` ``price_options``.
On the host the compiled routine ``csrc/host/binomial.cpp`` prices them in
the plain version's order.

``launches`` counts the kernel's launches and nothing else;
``host_calls`` counts the host routine's calls."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, host_build
from repro_torch.kernels.binomial import ref as R

launches = 0
host_calls = 0


def price_options(s0, strike, t_years, *, steps: int = R.STEPS):
    """(n,) float32 s0/strike/t_years -> (n,) option values.  CPU tensors
    run the host routine; CUDA tensors launch the kernel."""
    global launches, host_calls
    on_host = s0.device.type == "cpu"
    for name, t in (("s0", s0), ("strike", strike), ("t_years", t_years)):
        if on_host:
            host_build.check_host(f"price_options {name}", t, 1)
        else:
            build.check_cuda(f"price_options {name}", t, torch.float32, 1)
        if t.shape != s0.shape or t.device != s0.device:
            raise ValueError(f"price_options: {name} does not match s0")
    if not 1 <= steps < 256:
        raise ValueError(f"price_options: steps must be in [1, 255], "
                         f"got {steps}")
    out = torch.empty_like(s0)
    if on_host:
        host_build.call("host_binomial_price", s0.data_ptr(),
                        strike.data_ptr(), t_years.data_ptr(),
                        out.data_ptr(), s0.numel(), steps)
        host_calls += 1
        return out
    build.launch("binomial_price", s0, s0.data_ptr(), strike.data_ptr(),
                 t_years.data_ptr(), out.data_ptr(), s0.numel(), steps)
    launches += 1
    return out
