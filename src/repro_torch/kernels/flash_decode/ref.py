"""Plain PyTorch version of single-token cached attention with the
numerics of the JAX model's decode path (``models/layers.py``
``cached_decode_attention``): q cast to the cache's type, float32 scores
and softmax, the probabilities cast to the value cache's type, float32
sums."""
from __future__ import annotations

import math

import torch


def decode_attention(q, k_cache, v_cache, pos: int):
    """q: (B,H,D); caches: (B,Smax,KH,D); attends to cache positions
    [0, pos] -> (B,H,D) in q's dtype."""
    B, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).to(k_cache.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = s * (1.0 / math.sqrt(D))
    valid = torch.arange(k_cache.shape[1], device=q.device) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, n: int):
    """A rank's part of decode attention over a cache split by positions:
    q: (B,H,D); caches: (B,S,KH,D), the rank's stretch; attends to its
    rows [0, n) -> (o (B,H,D) float32, lse (B,H) float32, each head's
    natural log-sum-exp of its scaled scores).  The numerics of
    :func:`decode_attention` over those rows, the output left in float32;
    with ``n`` 0, o is 0 and lse -inf."""
    B, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).to(k_cache.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache[:, :n].float())
    s = s * (1.0 / math.sqrt(D))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache[:, :n].float())
    return out.reshape(B, H, D), torch.logsumexp(s, dim=-1).reshape(B, H)
