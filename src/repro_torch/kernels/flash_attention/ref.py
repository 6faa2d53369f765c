"""Plain PyTorch version of causal GQA attention: exact, with the scores
materialised.  Transcribes the JAX package's oracle
(``kernels/flash_attention/ref.py``) op for op."""
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
