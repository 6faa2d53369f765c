"""Plain PyTorch version of the selective scan (the Mamba1 recurrence):
a sequential loop over time in float32, transcribing the JAX package's
oracle (``kernels/mamba_scan/ref.py`` ``selective_scan_ref``).

    h_t = a_t * h_{t-1} + b_t ;  y_t = sum_s C_t[s] * h_t[:, s]

It carries h step by step rather than through a cumulative product of
``a``: ``a = exp(dt * A)`` with A down to -16 underflows such a product."""
from __future__ import annotations

import torch


def selective_scan(a, b, C, h0=None):
    """a, b: (B,S,di,ds); C: (B,S,ds); h0: (B,di,ds) or None (zeros),
    all float32 -> (y (B,S,di), h_T (B,di,ds))."""
    B, S, di, ds = a.shape
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=a.device)
         if h0 is None else h0.clone())
    ys = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, di), dtype=torch.float32, device=a.device))
    return y, h
