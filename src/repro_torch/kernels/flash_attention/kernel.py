"""Wrapper of the hand-written CUDA causal flash-attention kernels: the
forward (``csrc/flash_attention.cu``: work items of (batch, kv head,
query tile) holding the tile's rows of all G query heads, online softmax
in float32 registers; bfloat16 on ``wgmma`` in persistent CTAs fed by TMA
rings, with the softmax overlapped with the products, float32 on FMAs),
which replaces the JAX package's Pallas kernel
``kernels/flash_attention/kernel.py`` ``flash_attention``, and its
gradient (``csrc/flash_attention_bwd.cu``: a pass for each row's D_i,
then dK/dV by key tile and dQ by query tile, no atomics; bfloat16 on
``wgmma`` fed by TMA, float32 on FMAs).  The forward can keep each row's
log-sum-exp (base 2, float32 (B, H, S)), so that the backward forms the
probabilities without recomputing the softmax's statistics.

``flash_attention`` is differentiable: with grad enabled on CUDA tensors
it runs as a ``torch.autograd.Function`` whose forward keeps the
log-sum-exp and saves it with q, k, v and the output, and whose backward
is :func:`flash_attention_bwd`.  Without grad (serving, prefill) the
forward stores no log-sum-exp.  CPU tensors take the plain version
``attention_ref``, which autograd differentiates.

v (and so the output) may be narrower than q and k: MLA's q and k have
head dim 192 (128 nope + 64 rope columns) and its v 128.  The forward
takes v at its own width D_v (bfloat16 (D, D_v) in ``BF16_PAIRS``, on
``wgmma`` with 128-key tiles at (192, 128); float32 any D_v <= D), which
computes what the JAX package computes on v zero-padded to D, sliced
back.  The backward kernel takes equal widths: at D_v < D
:func:`flash_attention_bwd` pads v, the output and its gradient with
zeros to D and slices dv back.
The bfloat16 backward at 192 runs on ``wgmma`` (dK/dV in CTAs of 64 keys
whose two warpgroups split by output, dQ in 128 packed rows); the
float32 backward runs on FMAs at every D.  Nothing falls back: a
bfloat16 call either launches the ``wgmma`` kernels or raises.

``meta`` tensors stand for the card's in a plan (``launch/dryrun.py``):
the forward and the backward then make only what the kernels make (the
outputs, the kept log-sum-exp, the backward's D_i scratch; never the
plain version's S x S scores) and add the kernels' least operations and
bytes, the formulas of their bounds, to ``meta_cost``.

``launches`` counts the forward kernel's launches and ``bwd_launches``
the backward's calls (three kernels each), and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as R

launches = 0
bwd_launches = 0
meta_cost: dict = {}    # build.tally of the calls on meta tensors

MAX_HEAD_DIM = 192
# the wgmma kernel's (D, D_v): every dense config's, MLA's 128 + 64 with
# v at 128, and 192 with v as wide
BF16_PAIRS = ((64, 64), (80, 80), (128, 128), (192, 192), (192, 128))
BWD_MAX_HEAD_DIM = 192  # the backward kernel's
MAX_GROUP = 64          # query heads per kv head: one CTA holds >= 1 position


def _check(name, q, k, v, *more):
    """Raise on what the kernels do not take: q (B,S,H,D), k (B,S,KH,D),
    v (B,S,KH,D_v) and each of ``more`` (B,S,H,D_v), with D_v <= D
    (bfloat16: a pair of ``BF16_PAIRS``); returns (B, S, H, KH, D, D_v)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, "
                        f"got {q.dtype}")
    ts = (("q", q), ("k", k), ("v", v)) + more
    for tn, t in ts:
        build.check_cuda(f"{name} {tn}", t, q.dtype, 4, meta_ok=True)
        if t.device != q.device:
            raise ValueError(f"{name}: {tn} on another device")
    B, S, H, D = q.shape
    KH, DV = k.shape[2], v.shape[3]
    if k.shape != (B, S, KH, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    for tn, t in more:
        if t.shape != (B, S, H, DV):
            raise ValueError(f"{name}: {tn} {tuple(t.shape)} does not fit "
                             f"q {tuple(q.shape)} and v {tuple(v.shape)}")
    if (KH == 0 or H % KH or H // KH > MAX_GROUP or not 0 < D <= MAX_HEAD_DIM
            or not 0 < DV <= D
            or (q.dtype == torch.bfloat16 and (D, DV) not in BF16_PAIRS)):
        raise ValueError(f"{name}: H={H}, KH={KH}, D={D}, D_v={DV}, "
                         f"{q.dtype} not supported (H % KH == 0, H/KH <= "
                         f"{MAX_GROUP}, D_v <= D <= {MAX_HEAD_DIM}; "
                         f"bfloat16: (D, D_v) in {BF16_PAIRS})")
    if q.device.type != "meta" and any(t.data_ptr() % 16 for _, t in ts):
        raise ValueError(f"{name}: {', '.join(n for n, _ in ts)} must be "
                         f"16-byte aligned")
    return B, S, H, KH, D, DV


def flash_attention_fwd(q, k, v, keep_lse=False):
    """The forward kernel alone, outside autograd, on CUDA tensors: the
    output (B, S, H, D_v); with ``keep_lse`` also each row's log-sum-exp
    of its scaled scores (float32 (B, H, S), base 2), which the kernel
    then writes."""
    global launches
    B, S, H, KH, D, DV = _check("flash_attention", q, k, v)
    out = q.new_empty((B, S, H, DV))
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if keep_lse else None)
    if q.device.type == "meta":
        # Q.K^T at D and P.V at D_v; q, k read at D, v read and o written
        # at D_v
        ops = 2.0 * B * H * (D + DV) * S * (S + 1) / 2
        nbytes = q.element_size() * B * S * (H + KH) * (D + DV)
        build.tally(meta_cost, "flash_attention", ops,
                    nbytes + (4 * B * H * S if keep_lse else 0),
                    dot_flops=ops, transcendentals=B * H * S * (S + 1) / 2)
    elif B and S:
        build.launch("flash_attention_fwd", q, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), B, S, H, KH,
                     D, DV, int(q.dtype == torch.bfloat16))
        launches += 1
    return (out, lse) if keep_lse else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v, keep_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, dout.contiguous(), lse)


def flash_attention(q, k, v):
    """Causal GQA attention.  q: (B,S,H,D); k: (B,S,KH,D); v: (B,S,KH,D_v)
    with D_v <= D, float32 (D <= 192) or bfloat16 ((D, D_v) in
    ``BF16_PAIRS``), any S -> (B,S,H,D_v) in q's dtype.  CPU tensors take
    the plain version (at D_v < D on v zero-padded to D, sliced back: the
    JAX package's ops); CUDA tensors launch the kernel, and with grad
    enabled record its backward; ``meta`` tensors are planned (the
    module's docstring)."""
    if q.device.type == "cpu":
        dv = v.shape[-1]
        if dv < q.shape[-1]:
            vp = torch.nn.functional.pad(v, (0, q.shape[-1] - dv))
            return R.attention_ref(q, k, vp)[..., :dv]
        return R.attention_ref(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)


def flash_attention_bwd(q, k, v, out, dout, lse=None):
    """Gradient of causal GQA attention.  q: (B,S,H,D); k: (B,S,KH,D); v:
    (B,S,KH,D_v); out, dout: (B,S,H,D_v), all of one dtype (float32 or
    bfloat16, the forward's limits) -> (dq, dk, dv) in that dtype.
    ``lse``: each row's log-sum-exp as the forward keeps it (float32 (B,
    H, S), base 2); when it is None the forward kernel first runs again to
    write it.  CPU tensors take the plain version ``attention_bwd_ref``;
    CUDA tensors launch the kernels, which take equal widths: at D_v < D,
    v, out and dout are zero-padded to D (the padded columns add exact
    zeros to every sum) and dv's first D_v columns returned."""
    global bwd_launches
    if q.device.type == "cpu":
        return R.attention_bwd_ref(q, k, v, out, dout, lse)
    B, S, H, KH, D, DV = _check("flash_attention_bwd", q, k, v,
                                ("out", out), ("dout", dout))
    if lse is None:
        lse = flash_attention_fwd(q, k, v, keep_lse=True)[1]
    if DV < D:
        pad = (0, D - DV)
        F = torch.nn.functional
        dq, dk, dv = flash_attention_bwd(q, k, F.pad(v, pad), F.pad(out, pad),
                                         F.pad(dout, pad), lse)
        return dq, dk, dv[..., :DV]
    build.check_cuda("flash_attention_bwd lse", lse, torch.float32, 3,
                     meta_ok=True)
    if lse.shape != (B, H, S) or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} on "
                         f"{lse.device}, expected {(B, H, S)} on "
                         f"{q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B and S:
        dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            ops = 5.0 * B * H * D * S * S
            build.tally(meta_cost, "flash_attention_bwd", ops,
                        q.element_size() * 4 * B * S * D * (H + KH),
                        dot_flops=ops,
                        transcendentals=B * H * S * (S + 1) / 2)
            return dq, dk, dv
        build.launch("flash_attention_bwd", q, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), dsum.data_ptr(), B, S, H, KH, D,
                     int(q.dtype == torch.bfloat16))
        bwd_launches += 1
    return dq, dk, dv
