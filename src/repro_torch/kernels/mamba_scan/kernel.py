"""Wrapper of the hand-written CUDA selective-scan kernel
(``csrc/selective_scan.cu``: parallel over (batch, channel, state), one
lane per state of a channel and the state in a register over the whole
sequence, y summed across the channel's lanes with warp shuffles), which
replaces the JAX package's Pallas kernel ``kernels/mamba_scan/kernel.py``
``selective_scan``.

The kernel has no backward yet: with grad enabled on a CUDA input that
requires grad the wrapper raises ``NotImplementedError`` rather than
return outputs that autograd cannot differentiate (ROADMAP.md Queue B
item 3).  The plain version, which CPU tensors take, is differentiable.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ref as R

launches = 0

MAX_STATE = 32          # one lane per state: a channel within one warp
MAX_BATCH = 65535       # the grid's y dimension


def selective_scan(a, b, C, h0=None):
    """a, b: (B,S,di,ds); C: (B,S,ds); h0: (B,di,ds) or None (zeros); all
    float32, ds <= 32, any S and di -> (y (B,S,di), h_T (B,di,ds)) in
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, which has no backward: under grad, inputs that require grad
    raise ``NotImplementedError``."""
    global launches
    if a.device.type == "cpu":
        return R.selective_scan(a, b, C, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, C, h0)):
        raise NotImplementedError(
            "selective_scan: the CUDA kernel has no backward yet, so its "
            "outputs cannot carry a gradient (the scan's backward is "
            "ROADMAP.md Queue B item 3)")
    f32 = torch.float32
    build.check_cuda("selective_scan a", a, f32, 4)
    build.check_cuda("selective_scan b", b, f32, 4)
    build.check_cuda("selective_scan C", C, f32, 3)
    if h0 is not None:
        build.check_cuda("selective_scan h0", h0, f32, 3)
    B, S, di, ds = a.shape
    if (b.shape != a.shape or C.shape != (B, S, ds)
            or (h0 is not None and h0.shape != (B, di, ds))):
        raise ValueError(
            f"selective_scan: b {tuple(b.shape)}, C {tuple(C.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not fit a "
            f"{tuple(a.shape)}")
    if any(t is not None and t.device != a.device for t in (b, C, h0)):
        raise ValueError("selective_scan: arguments on different devices")
    if not 0 < ds <= MAX_STATE or B > MAX_BATCH:
        raise ValueError(f"selective_scan: ds={ds}, B={B} not supported "
                         f"(1 <= ds <= {MAX_STATE}, B <= {MAX_BATCH})")
    y = torch.empty((B, S, di), dtype=f32, device=a.device)
    h = torch.empty((B, di, ds), dtype=f32, device=a.device)
    if B and di:
        build.launch("selective_scan_fwd", a, a.data_ptr(), b.data_ptr(),
                     C.data_ptr(), None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), h.data_ptr(), B, S, di, ds)
        launches += 1
    return y, h
