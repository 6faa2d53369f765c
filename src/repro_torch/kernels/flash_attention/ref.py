"""Plain PyTorch versions of causal GQA attention and of its gradient:
exact, with the scores materialised.  ``attention_ref`` transcribes the
JAX package's oracle (``kernels/flash_attention/ref.py``) op for op;
``attention_lse_ref`` is the log-sum-exp that the forward kernel keeps
for the backward, and ``attention_bwd_ref`` the plain version of the
backward kernel (``csrc/flash_attention_bwd.cu``)."""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634


def attention_ref(q, k, v):
    """q: (B,S,H,D); k: (B,S,KH,D); v: (B,S,KH,D_v) with H % KH == 0 ->
    (B,S,H,D_v) in q's dtype; scores, softmax and the value sum in
    float32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def _scores(q, k):
    """The scaled causal scores, float32 (B, KH, G, S, S), -inf above the
    diagonal."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def attention_lse_ref(q, k, v):
    """Each query row's log-sum-exp of its scaled causal scores, in base
    2: log2 sum_t exp(q.k_t / sqrt(D)) over keys t <= the row's position,
    what the forward kernel writes for the backward.  q: (B,S,H,D); k, v:
    (B,S,KH,D) (v is not read: the arguments are the forward's) -> float32
    (B, H, S)."""
    B, S, H, _ = q.shape
    lse = torch.logsumexp(_scores(q, k), dim=-1) * LOG2E   # (B,KH,G,S)
    return lse.reshape(B, H, S)


def attention_bwd_ref(q, k, v, out, dout, lse=None):
    """Gradient of :func:`attention_ref` by the explicit formulas, with
    the probabilities P materialised in float32: dV = P^T dO, dP = dO V^T,
    D_i = sum_d dO*O, dS = P (dP - D_i), dQ = dS K / sqrt(D), dK = dS^T Q
    / sqrt(D).  q: (B,S,H,D); k: (B,S,KH,D); v: (B,S,KH,D_v); out, dout:
    (B,S,H,D_v) -> (dq, dk, dv) in the inputs' dtypes.  With ``lse``
    (float32 (B, H, S), as :func:`attention_lse_ref` gives it) P is
    formed from it as the kernel forms it, 2^(s log2 e - lse), instead of
    by a softmax."""
    B, S, H, D = q.shape
    KH, DV = k.shape[2], v.shape[3]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KH, G, D).float()
    dog = dout.reshape(B, S, KH, G, DV).float()
    og = out.reshape(B, S, KH, G, DV).float()
    s = _scores(q, k)
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        if lse.shape != (B, H, S) or lse.dtype != torch.float32:
            raise ValueError(f"attention_bwd_ref: lse {tuple(lse.shape)} "
                             f"{lse.dtype}, expected float32 {(B, H, S)}")
        p = torch.exp2(s * LOG2E - lse.reshape(B, KH, G, S, 1))
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    di = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # (B,KH,G,S,1)
    ds = p * (dp - di)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
