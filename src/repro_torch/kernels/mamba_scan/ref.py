"""Plain PyTorch version of the selective scan (the Mamba1 recurrence):
a sequential loop over time in float32, transcribing the JAX package's
oracle (``kernels/mamba_scan/ref.py`` ``selective_scan_ref``).

    h_t = a_t * h_{t-1} + b_t ;  y_t = sum_s C_t[s] * h_t[:, s]

It carries h step by step rather than through a cumulative product of
``a``: ``a = exp(dt * A)`` with A down to -16 underflows such a product.
:func:`selective_scan_bwd_ref` is the plain version of the backward
kernel; on the host autograd differentiates :func:`selective_scan`.

:func:`selective_scan_fused` is the plain version of the fused kernel:
Mamba's eager discretisation (``models/layers.py``, transcribing the JAX
package's ``models/layers.py:608-611``) followed by :func:`selective_scan`,
and :func:`selective_scan_fused_bwd_ref` that of its backward."""
from __future__ import annotations

import torch


def selective_scan(a, b, C, h0=None):
    """a, b: (B,S,di,ds); C: (B,S,ds); h0: (B,di,ds) or None (zeros),
    all float32 -> (y (B,S,di), h_T (B,di,ds))."""
    B, S, di, ds = a.shape
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=a.device)
         if h0 is None else h0.clone())
    ys = []
    # unbind, not a[:, t]: autograd then stacks the steps' gradients once,
    # where each indexed step's backward would fill a whole zero (B,S,di,ds)
    for at, bt, ct in zip(a.unbind(1), b.unbind(1), C.unbind(1)):
        h = at * h + bt
        ys.append(torch.einsum("bds,bs->bd", h, ct))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, di), dtype=torch.float32, device=a.device))
    return y, h


def selective_scan_bwd_ref(a, b, C, h0, dy, dhT=None):
    """The scan's gradient, a reverse loop over time in float32: the plain
    version of the backward kernel.  a, b: (B,S,di,ds); C: (B,S,ds); h0:
    (B,di,ds) or None (zeros); dy: (B,S,di); dhT: (B,di,ds) or None
    (zeros) -> (da, db, dC, dh0) in the shapes of a, b, C and h0.

        g_t = dy_t (x) C_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT)
        da_t = g_t h_{t-1} ;  db_t = g_t ;  dC_t[s] = sum_d dy_t[d] h_t[d,s]
        dh0 = a_0 g_0

    The states h_t are recomputed forward first."""
    B, S, di, ds = a.shape
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=a.device)
         if h0 is None else h0)
    hs = [h]                                  # hs[t + 1] = h_t
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    da, db = torch.empty_like(a), torch.empty_like(b)
    dC = torch.empty_like(C)
    carry = (torch.zeros((B, di, ds), dtype=torch.float32, device=a.device)
             if dhT is None else dhT)         # a_{t+1} g_{t+1}
    for t in range(S - 1, -1, -1):
        g = dy[:, t, :, None] * C[:, t, None, :] + carry
        da[:, t] = g * hs[t]
        db[:, t] = g
        dC[:, t] = torch.einsum("bd,bds->bs", dy[:, t], hs[t + 1])
        carry = a[:, t] * g
    return da, db, dC, carry


def selective_scan_fused(dt, x, A, B, C, h0=None):
    """dt, x: (B,S,di) in the model's type; A: (di,ds); B, C: (B,S,ds);
    h0: (B,di,ds) or None (zeros); all but dt and x float32 -> (y
    (B,S,di), h_T (B,di,ds)): the scan of ``a = exp(dt A)`` and ``b = (dt
    x) B``, formed as (B,S,di,ds) planes in the JAX package's order of
    products."""
    dt32 = dt.float()
    a = torch.exp(dt32[..., None] * A)                      # (B,S,di,ds)
    b = (dt32 * x.float())[..., None] * B[:, :, None, :]
    return selective_scan(a, b, C, h0)


def selective_scan_fused_bwd_ref(dt, x, A, B, C, h0, dy, dhT=None):
    """The fused scan's gradient, a reverse loop over time in float32: the
    plain version of the fused backward kernel.  Arguments as
    :func:`selective_scan_fused`'s, dy: (B,S,di) float32, dhT: (B,di,ds)
    or None (zeros) -> (d_dt, d_x, dA, dB, dC, dh0): d_dt and d_x in dt's
    type, the rest float32 in the shapes of A, B, C and (B,di,ds).

        g_t = dy_t (x) C_t + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT)
        q_t = g_t h_{t-1} a_t ;  u_t = dt_t x_t
        d_dt_t = sum_s q_t A + x_t sum_s g_t B_t
        d_x_t = dt_t sum_s g_t B_t ;  dA = sum_{b,t} q_t dt_t
        dB_t = sum_d g_t u_t ;  dC_t = sum_d dy_t h_t ;  dh0 = a_0 g_0

    The states h_t are recomputed forward first."""
    Bn, S, di = dt.shape
    ds = A.shape[1]
    dev, f32 = dt.device, torch.float32
    dt32, x32 = dt.float(), x.float()
    u = dt32 * x32                                            # (B,S,di)
    h = (torch.zeros((Bn, di, ds), dtype=f32, device=dev)
         if h0 is None else h0)
    hs = [h]                                  # hs[t + 1] = h_t
    for t in range(S):
        a = torch.exp(dt32[:, t, :, None] * A)
        h = a * h + u[:, t, :, None] * B[:, t, None, :]
        hs.append(h)
    d_dt = torch.empty((Bn, S, di), dtype=f32, device=dev)
    d_x = torch.empty_like(d_dt)
    dA = torch.zeros((di, ds), dtype=f32, device=dev)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    carry = (torch.zeros((Bn, di, ds), dtype=f32, device=dev)
             if dhT is None else dhT)         # a_{t+1} g_{t+1}
    for t in range(S - 1, -1, -1):
        a = torch.exp(dt32[:, t, :, None] * A)
        g = dy[:, t, :, None] * C[:, t, None, :] + carry
        q = g * hs[t] * a
        gb = torch.einsum("bds,bs->bd", g, B[:, t])
        d_dt[:, t] = torch.einsum("bds,ds->bd", q, A) + gb * x32[:, t]
        d_x[:, t] = gb * dt32[:, t]
        dA += torch.einsum("bds,bd->ds", q, dt32[:, t])
        dB[:, t] = torch.einsum("bds,bd->bs", g, u[:, t])
        dC[:, t] = torch.einsum("bd,bds->bs", dy[:, t], hs[t + 1])
        carry = a * g
    return d_dt.to(dt.dtype), d_x.to(x.dtype), dA, dB, dC, carry
