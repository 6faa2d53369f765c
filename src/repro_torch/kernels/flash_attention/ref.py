"""Plain PyTorch versions of causal GQA attention and of its gradient:
exact, with the scores materialised.  ``attention_ref`` transcribes the
JAX package's oracle (``kernels/flash_attention/ref.py``) op for op;
``attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v):
    """q: (B,S,H,D); k,v: (B,S,KH,D) with H % KH == 0 -> (B,S,H,D) in
    q's dtype; scores, softmax and the value sum in float32."""
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
    return o.reshape(B, S, H, D).to(q.dtype)


def attention_bwd_ref(q, k, v, out, dout):
    """Gradient of :func:`attention_ref` by the explicit formulas, with
    the probabilities P materialised in float32: dV = P^T dO, dP = dO V^T,
    D_i = sum_d dO*O, dS = P (dP - D_i), dQ = dS K / sqrt(D), dK = dS^T Q
    / sqrt(D).  q, out, dout: (B,S,H,D); k, v: (B,S,KH,D) -> (dq, dk, dv)
    in the inputs' dtypes."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KH, G, D).float()
    dog = dout.reshape(B, S, KH, G, D).float()
    og = out.reshape(B, S, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    di = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # (B,KH,G,S,1)
    ds = p * (dp - di)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
