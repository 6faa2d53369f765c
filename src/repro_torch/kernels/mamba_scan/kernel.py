"""Wrapper of the hand-written CUDA selective-scan kernels
(``csrc/selective_scan.cu``), in two forms built from one template: the
forward (parallel over (batch, channel, state), one lane per state of a
channel and the state in a register over the whole sequence, y summed
across the channel's lanes by a transposed butterfly over a chunk of
``CHUNK`` steps), which replaces the JAX package's Pallas kernel
``kernels/mamba_scan/kernel.py`` ``selective_scan``, and its gradient
(the same layout walking the chunks from the last to the first: each
chunk's states recomputed from the state the forward kept at its start,
then the reverse recurrence; sums over channels as per-CTA partials
summed in a second pass, no atomics).

The (a, b, C) form (:func:`selective_scan`) takes the discretised
(B, S, di, ds) planes a and b.  The fused form
(:func:`selective_scan_fused`), which the model runs, takes dt and x (B,
S, di) in the model's type, A (di, ds) and B, C (B, S, ds) and forms
``a = exp(dt A)`` and ``b = (dt x) B`` in registers, from dt/x and B/C
tiles staged through shared memory by asynchronous copies: no (B, S, di,
ds) plane reaches device memory, forward or backward.

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
the backward's calls (two kernels each), ``fused_launches`` and
``fused_bwd_launches`` those of the fused form, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ref as R

launches = 0
bwd_launches = 0
fused_launches = 0
fused_bwd_launches = 0
meta_cost: dict = {}    # build.tally of the calls on meta tensors

MAX_STATE = 32          # one lane per state: a channel within one warp
MAX_BATCH = 65535       # the grid's y dimension
CHUNK = 16              # steps between the states the forward keeps
THREADS = 256           # a CTA's threads at most, L >= ds lanes a channel
MAX_CHANNELS = 32       # a CTA's channels at most: min(256 / L, 32)
# the fused form's dt and x types, by the kernels' code for them
FUSED_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# the fused kernels' least float operations per (t, d, s), their exp
# apart (one transcendental): the forward's dt A, b's product, the fma,
# y's product and its share of the sum; the backward's recompute of the
# state (dt A, b, the fma: 4), g (2), q (2), dA's term (2), the two lane
# sums' terms and shares (4), dB's and dC's terms and shares (4), the
# carry (1)
FUSED_FLOPS = 6.0
FUSED_BWD_FLOPS = 19.0


def _parts(B, S, di, ds):
    """Floats of one array of the backward's per-CTA partials: (B,
    CTAs, S, ds), a CTA holding ``min(THREADS / L, MAX_CHANNELS)``
    channels."""
    lanes = 1 << (ds - 1).bit_length()          # L, the kernel's group
    return B * -(-di // min(THREADS // lanes, MAX_CHANNELS)) * S * ds


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
    n_part = _parts(B, S, di, ds)
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


# ------------------------------------------------------------ fused form
def _check_fused(name, dt, x, A, B, C, h0, *more):
    """Raise on what the fused kernels do not take; returns (B, S, di,
    ds)."""
    f32 = torch.float32
    build.check_cuda(f"{name} dt", dt, dt.dtype, 3, meta_ok=True)
    if dt.dtype not in FUSED_TYPES:
        raise TypeError(f"{name}: dt of {dt.dtype}, expected one of "
                        f"{list(FUSED_TYPES)}")
    build.check_cuda(f"{name} x", x, dt.dtype, 3, meta_ok=True)
    build.check_cuda(f"{name} A", A, f32, 2, meta_ok=True)
    build.check_cuda(f"{name} B", B, f32, 3, meta_ok=True)
    build.check_cuda(f"{name} C", C, f32, 3, meta_ok=True)
    if h0 is not None:
        build.check_cuda(f"{name} h0", h0, f32, 3, meta_ok=True)
    Bn, S, di = dt.shape
    ds = A.shape[1]
    if (x.shape != dt.shape or A.shape[0] != di or B.shape != (Bn, S, ds)
            or C.shape != B.shape
            or (h0 is not None and h0.shape != (Bn, di, ds))):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, A {tuple(A.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not fit dt "
            f"{tuple(dt.shape)}")
    for tn, t, shape, dtype in more:
        if t is None:
            continue
        build.check_cuda(f"{name} {tn}", t, dtype, len(shape), meta_ok=True)
        if t.shape != shape:
            raise ValueError(f"{name}: {tn} {tuple(t.shape)}, expected "
                             f"{shape}")
    if any(t is not None and t.device != dt.device
           for t in (x, A, B, C, h0) + tuple(m[1] for m in more)):
        raise ValueError(f"{name}: arguments on different devices")
    if not 0 < ds <= MAX_STATE or Bn > MAX_BATCH:
        raise ValueError(f"{name}: ds={ds}, B={Bn} not supported "
                         f"(1 <= ds <= {MAX_STATE}, B <= {MAX_BATCH})")
    return Bn, S, di, ds


def selective_scan_fused_fwd(dt, x, A, B, C, h0=None, keep_states=False):
    """The fused forward kernel alone, outside autograd, on CUDA tensors:
    (y, h_T); with ``keep_states`` also the state entering each chunk of
    ``CHUNK`` steps (float32 (B, ceil(S/CHUNK), di, ds))."""
    global fused_launches
    Bn, S, di, ds = _check_fused("selective_scan_fused", dt, x, A, B, C, h0)
    dev = dt.device
    y = torch.empty((Bn, S, di), dtype=torch.float32, device=dev)
    h = torch.empty((Bn, di, ds), dtype=torch.float32, device=dev)
    states = (torch.empty((Bn, -(-S // CHUNK), di, ds), dtype=torch.float32,
                          device=dev) if keep_states else None)
    if dev.type == "meta":
        # dt and x read, FUSED_FLOPS and an exp per (t, d, s)
        build.tally(meta_cost, "selective_scan_fused",
                    FUSED_FLOPS * Bn * S * di * ds,
                    2.0 * dt.element_size() * Bn * S * di
                    + 4.0 * (di * ds + 2 * Bn * S * ds + Bn * S * di
                             + Bn * di * ds * (1 if h0 is None else 2)
                             + (states.numel() if keep_states else 0)),
                    transcendentals=float(Bn * S * di * ds))
    elif Bn and di:
        build.launch("selective_scan_fused_fwd", dt, dt.data_ptr(),
                     x.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                     None if h0 is None else h0.data_ptr(), y.data_ptr(),
                     h.data_ptr(),
                     None if states is None else states.data_ptr(), Bn, S,
                     di, ds, FUSED_TYPES[dt.dtype])
        fused_launches += 1
    return (y, h, states) if keep_states else (y, h)


class _SelectiveScanFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, x, A, B, C, h0):
        y, h, states = selective_scan_fused_fwd(dt, x, A, B, C, h0,
                                                keep_states=True)
        ctx.set_materialize_grads(False)    # h_T is unused in training
        ctx.save_for_backward(dt, x, A, B, C, h0, states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, x, A, B, C, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        d_dt, d_x, dA, dB, dC, dh0 = selective_scan_fused_bwd(
            dt, x, A, B, C, h0, dy.contiguous(),
            None if dhT is None else dhT.contiguous(), states,
            need_dA=ctx.needs_input_grad[2])
        return (d_dt, d_x, dA, dB, dC,
                dh0 if ctx.needs_input_grad[5] else None)


def selective_scan_fused(dt, x, A, B, C, h0=None):
    """Mamba's discretisation and scan in one: dt, x: (B,S,di) float32 or
    bfloat16 (one type); A: (di,ds); B, C: (B,S,ds); h0: (B,di,ds) or None
    (zeros); all but dt and x float32, ds <= 32 -> (y (B,S,di), h_T
    (B,di,ds)) in float32, the scan of ``a = exp(dt A)`` and ``b = (dt x)
    B``.  CPU tensors take the plain version; CUDA tensors launch the
    fused kernel, and with grad enabled on inputs that require grad record
    its backward."""
    if dt.device.type == "cpu":
        return R.selective_scan_fused(dt, x, A, B, C, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (dt, x, A, B, C, h0)):
        return _SelectiveScanFused.apply(dt, x, A, B, C, h0)
    return selective_scan_fused_fwd(dt, x, A, B, C, h0)


def selective_scan_fused_bwd(dt, x, A, B, C, h0, dy, dhT=None, states=None,
                             need_dA=True):
    """Gradient of the fused scan.  dt, x, A, B, C, h0 as the forward
    took them; dy: (B,S,di) float32; dhT: (B,di,ds) or None (zeros);
    ``states``: the states the fused forward kept, or None, and then it
    first runs again to write them -> (d_dt, d_x, dA, dB, dC, dh0): d_dt
    and d_x in dt's type, the rest float32; dA is None without
    ``need_dA``.  CPU tensors take the plain version
    ``selective_scan_fused_bwd_ref``; CUDA tensors launch the kernels."""
    global fused_bwd_launches
    if dt.device.type == "cpu":
        out = R.selective_scan_fused_bwd_ref(dt, x, A, B, C, h0, dy, dhT)
        return out if need_dA else out[:2] + (None,) + out[3:]
    Bn, S, di = dt.shape
    ds = A.shape[1]
    nc = -(-S // CHUNK)
    f32 = torch.float32
    _check_fused("selective_scan_fused_bwd", dt, x, A, B, C, h0,
                 ("dy", dy, (Bn, S, di), f32),
                 ("dhT", dhT, (Bn, di, ds), f32),
                 ("states", states, (Bn, nc, di, ds), f32))
    if states is None:
        states = selective_scan_fused_fwd(dt, x, A, B, C, h0,
                                          keep_states=True)[2]
    dev = dt.device
    d_dt, d_x = torch.empty_like(dt), torch.empty_like(x)
    dA = torch.empty((di, ds), dtype=f32, device=dev) if need_dA else None
    dCB = torch.empty((2, Bn, S, ds), dtype=f32, device=dev)
    dh0 = torch.empty((Bn, di, ds), dtype=f32, device=dev)
    n_part = _parts(Bn, S, di, ds)
    if dev.type == "meta":
        torch.empty(2 * n_part, dtype=f32, device=dev)
        if need_dA:
            torch.empty((Bn, di, ds), dtype=f32, device=dev)
        # FUSED_BWD_FLOPS and an exp per (t, d, s)
        build.tally(meta_cost, "selective_scan_fused_bwd",
                    FUSED_BWD_FLOPS * Bn * S * di * ds,
                    4.0 * dt.element_size() * Bn * S * di
                    + 4.0 * (Bn * S * di + 4 * Bn * S * ds + states.numel()
                             + di * ds * (2 if need_dA else 1)
                             + Bn * di * ds
                             * (1 + (h0 is not None) + (dhT is not None))),
                    transcendentals=float(Bn * S * di * ds))
        return d_dt, d_x, dA, dCB[1], dCB[0], dh0
    if not (Bn and S and di):     # nothing to launch: dh0 is dhT, the rest 0
        for t in (d_dt, d_x, dCB) + ((dA,) if need_dA else ()):
            t.zero_()
        if dhT is None:
            dh0.zero_()
        else:
            dh0.copy_(dhT)
        return d_dt, d_x, dA, dCB[1], dCB[0], dh0
    part = torch.empty(2 * n_part, dtype=f32, device=dev)
    dA_part = (torch.empty((Bn, di, ds), dtype=f32, device=dev) if need_dA
               else None)
    build.launch("selective_scan_fused_bwd", dt, dt.data_ptr(),
                 x.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                 states.data_ptr(), dy.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), d_dt.data_ptr(),
                 d_x.data_ptr(), None if dA is None else dA.data_ptr(),
                 None if dA_part is None else dA_part.data_ptr(),
                 dCB.data_ptr(), part.data_ptr(), dh0.data_ptr(), Bn, S, di,
                 ds, FUSED_TYPES[dt.dtype], n_part)
    fused_bwd_launches += 1
    return d_dt, d_x, dA, dCB[1], dCB[0], dh0
