"""Wrapper of the hand-written CUDA selective-scan kernels
(``csrc/selective_scan.cu``): the forward (parallel over (batch, channel,
state), one lane per state of a channel and the state in a register over
the whole sequence, y summed across the channel's lanes with warp
shuffles), which replaces the JAX package's Pallas kernel
``kernels/mamba_scan/kernel.py`` ``selective_scan``, and its gradient
(the same layout walking chunks of ``CHUNK`` steps from the last to the
first: each chunk's states recomputed from the state the forward kept at
its start, then the reverse recurrence; dC's sum over channels as
per-CTA partials summed in a second pass, no atomics).

``selective_scan`` is differentiable: with grad enabled on CUDA tensors
that require grad it runs as a ``torch.autograd.Function`` whose forward
also keeps the state entering every chunk (float32 (B, ceil(S/CHUNK),
di, ds)) and saves it with a, b, C and h0, and whose backward is
:func:`selective_scan_bwd`.  Without grad (serving, prefill) the forward
keeps no states.  CPU tensors take the plain version, which autograd
differentiates.

``meta`` tensors stand for the card's in a plan (``launch/dryrun.py``):
the forward and the backward then make only what the kernels make (the
outputs, the kept states, the backward's dC partials) and add the
kernels' least operations and bytes to ``meta_cost``.

``launches`` counts the forward kernel's launches and ``bwd_launches``
the backward's calls (two kernels each), and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ref as R

launches = 0
bwd_launches = 0
meta_cost: dict = {}    # build.tally of the calls on meta tensors

MAX_STATE = 32          # one lane per state: a channel within one warp
MAX_BATCH = 65535       # the grid's y dimension
CHUNK = 16              # steps between the states the forward keeps
THREADS = 256           # a CTA's threads: 256 / L channels, L >= ds


def _check(name, a, b, C, h0, *more):
    """Raise on what the kernels do not take; returns (B, S, di, ds)."""
    f32 = torch.float32
    build.check_cuda(f"{name} a", a, f32, 4, meta_ok=True)
    build.check_cuda(f"{name} b", b, f32, 4, meta_ok=True)
    build.check_cuda(f"{name} C", C, f32, 3, meta_ok=True)
    if h0 is not None:
        build.check_cuda(f"{name} h0", h0, f32, 3, meta_ok=True)
    B, S, di, ds = a.shape
    if (b.shape != a.shape or C.shape != (B, S, ds)
            or (h0 is not None and h0.shape != (B, di, ds))):
        raise ValueError(
            f"{name}: b {tuple(b.shape)}, C {tuple(C.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not fit a "
            f"{tuple(a.shape)}")
    for tn, t, shape in more:
        if t is None:
            continue
        build.check_cuda(f"{name} {tn}", t, f32, len(shape), meta_ok=True)
        if t.shape != shape:
            raise ValueError(f"{name}: {tn} {tuple(t.shape)}, expected "
                             f"{shape}")
    if any(t is not None and t.device != a.device
           for t in (b, C, h0) + tuple(m[1] for m in more)):
        raise ValueError(f"{name}: arguments on different devices")
    if not 0 < ds <= MAX_STATE or B > MAX_BATCH:
        raise ValueError(f"{name}: ds={ds}, B={B} not supported "
                         f"(1 <= ds <= {MAX_STATE}, B <= {MAX_BATCH})")
    return B, S, di, ds


def selective_scan_fwd(a, b, C, h0=None, keep_states=False):
    """The forward kernel alone, outside autograd, on CUDA tensors: (y,
    h_T); with ``keep_states`` also the state entering each chunk of
    ``CHUNK`` steps (float32 (B, ceil(S/CHUNK), di, ds)), which the
    kernel then writes."""
    global launches
    B, S, di, ds = _check("selective_scan", a, b, C, h0)
    y = torch.empty((B, S, di), dtype=torch.float32, device=a.device)
    h = torch.empty((B, di, ds), dtype=torch.float32, device=a.device)
    states = (torch.empty((B, -(-S // CHUNK), di, ds), dtype=torch.float32,
                          device=a.device) if keep_states else None)
    if a.device.type == "meta":
        build.tally(meta_cost, "selective_scan", B * S * di * (4.0 * ds - 1),
                    4.0 * (2 * B * S * di * ds + B * S * ds + B * S * di
                           + B * di * ds * (1 if h0 is None else 2)
                           + (states.numel() if keep_states else 0)))
    elif B and di:
        build.launch("selective_scan_fwd", a, a.data_ptr(), b.data_ptr(),
                     C.data_ptr(), None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), h.data_ptr(),
                     None if states is None else states.data_ptr(), B, S,
                     di, ds)
        launches += 1
    return (y, h, states) if keep_states else (y, h)


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, C, h0):
        y, h, states = selective_scan_fwd(a, b, C, h0, keep_states=True)
        ctx.set_materialize_grads(False)    # h_T is unused in training
        ctx.save_for_backward(a, b, C, h0, states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dhT):
        a, b, C, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(a.shape[:3], dtype=torch.float32,
                             device=a.device)
        da, db, dC, dh0 = selective_scan_bwd(
            a, b, C, h0, dy.contiguous(),
            None if dhT is None else dhT.contiguous(), states)
        return da, db, dC, dh0 if ctx.needs_input_grad[3] else None


def selective_scan(a, b, C, h0=None):
    """a, b: (B,S,di,ds); C: (B,S,ds); h0: (B,di,ds) or None (zeros); all
    float32, ds <= 32, any S and di -> (y (B,S,di), h_T (B,di,ds)) in
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, and with grad enabled on inputs that require grad record its
    backward."""
    if a.device.type == "cpu":
        return R.selective_scan(a, b, C, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, C, h0)):
        return _SelectiveScan.apply(a, b, C, h0)
    return selective_scan_fwd(a, b, C, h0)


def selective_scan_bwd(a, b, C, h0, dy, dhT=None, states=None):
    """Gradient of the scan.  a, b, C, h0 as the forward took them; dy:
    (B,S,di); dhT: (B,di,ds) or None (zeros); ``states``: the states the
    forward kept (``selective_scan_fwd(..., keep_states=True)``), or None,
    and then the forward kernel first runs again to write them; all
    float32 -> (da, db, dC, dh0) in the shapes of a, b, C and (B,di,ds).
    CPU tensors take the plain version ``selective_scan_bwd_ref``; CUDA
    tensors launch the kernels."""
    global bwd_launches
    if a.device.type == "cpu":
        return R.selective_scan_bwd_ref(a, b, C, h0, dy, dhT)
    B, S, di, ds = a.shape
    nc = -(-S // CHUNK)
    _check("selective_scan_bwd", a, b, C, h0, ("dy", dy, (B, S, di)),
           ("dhT", dhT, (B, di, ds)), ("states", states, (B, nc, di, ds)))
    if states is None:
        states = selective_scan_fwd(a, b, C, h0, keep_states=True)[2]
    da, db, dC = torch.empty_like(a), torch.empty_like(b), torch.empty_like(C)
    dh0 = torch.empty((B, di, ds), dtype=torch.float32, device=a.device)
    lanes = 1 << (ds - 1).bit_length()          # L, the kernel's group
    n_part = B * -(-di // (THREADS // lanes)) * S * ds
    if a.device.type == "meta":
        torch.empty(n_part, dtype=torch.float32, device=a.device)
        build.tally(meta_cost, "selective_scan_bwd", 8.0 * B * S * di * ds,
                    4.0 * (4 * B * S * di * ds + 2 * B * S * ds + B * S * di
                           + states.numel() + B * di * ds
                           * (1 + (h0 is not None) + (dhT is not None))))
        return da, db, dC, dh0
    if not (B and S and di):      # nothing to launch: dh0 is dhT, dC zeros
        dC.zero_()
        if dhT is None:
            dh0.zero_()
        else:
            dh0.copy_(dhT)
        return da, db, dC, dh0
    part = torch.empty(n_part, dtype=torch.float32, device=a.device)
    build.launch("selective_scan_bwd", a, a.data_ptr(), b.data_ptr(),
                 C.data_ptr(), states.data_ptr(), dy.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), da.data_ptr(),
                 db.data_ptr(), dC.data_ptr(), part.data_ptr(),
                 dh0.data_ptr(), B, S, di, ds, n_part)
    bwd_launches += 1
    return da, db, dC, dh0
