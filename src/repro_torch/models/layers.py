"""Model layers of the dense GQA decoder: RMSNorm, RoPE, causal attention
(prefill) and cached single-token attention (decode), the GQA attention
layer and the SwiGLU MLP.  A PyTorch port of the dense part of the JAX
package's ``models/layers.py``, with its numerics.

Attention goes through the two hand-written CUDA kernels: causal prefill
attention through ``kernels/flash_attention`` and cached decode attention
through ``kernels/flash_decode``.  The tensor's device picks the path: a
CUDA tensor launches the kernel, a CPU tensor takes its plain version.
The projections stay ``torch.matmul``, as the JAX package leaves them to
XLA.

Parameters are ``nn.Module``s in a matmul layout (``x @ w``): ``wq`` is
(d_model, H*hd), ``wk``/``wv`` (d_model, KH*hd) and ``wo`` (H*hd,
d_model); ``models/convert.py`` maps the JAX package's (d, H, hd) and
(H, hd, d) arrays onto them.

The Mamba1 block (falcon-mamba) keeps the JAX package's parameter names
and layouts; its prefill scan goes through the hand-written CUDA kernel
of ``kernels/mamba_scan``, and its decode step is one recurrence step in
plain ops, as in the JAX package.  MLA and MoE layers are later slices of
the port.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.mamba_scan.kernel import selective_scan


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Abstract:
    """Stands in for a ``torch.Generator`` when only the parameters'
    shapes are wanted: every ``*_init`` then builds on the ``meta``
    device and allocates nothing."""
    device = torch.device("meta")


ABSTRACT = _Abstract()


def _dense_init(gen: torch.Generator, shape, dtype, fan_in: int,
                scale: Optional[float] = None) -> nn.Parameter:
    """Normal(0, 1/sqrt(fan_in)) (or ``scale``) in float32, cast to
    ``dtype``, on the generator's device; frozen (serving keeps it so,
    training calls ``requires_grad_``).  On the ``meta`` device
    (:data:`ABSTRACT`) only the shape and dtype are made."""
    if gen.device.type == "meta":
        return _frozen(torch.empty(shape, dtype=dtype, device="meta"))
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return _frozen(w.to(dtype))


def _ones(n: int, dtype, device) -> nn.Parameter:
    return _frozen(torch.ones(n, dtype=dtype, device=device))


def rmsnorm(x, w, eps):
    # cast back to x's dtype BEFORE the weight, as the JAX package does
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, dim, theta, dtype=torch.float32):
    """positions: (...,) int tensor -> cos/sin (..., dim/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (S, D/2).  Rotates the two halves of
    the head (not interleaved pairs); the float32 product is cast back to
    x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def blocked_causal_attention(q, k, v, chunk: int = 2048):
    """Exact causal attention. q: (B,S,H,D); k,v: (B,S,KH,D).  ``chunk``
    is the JAX schedule's kv-block size; the kernel picks its own tiles
    and takes any S, and neither changes the result beyond rounding."""
    del chunk
    return flash_attention(q, k, v)


def cached_decode_attention(q, k_cache, v_cache, pos: int):
    """Single-token attention over a static-size cache.
    q: (B,1,H,D); caches: (B,Smax,KH,D) in their storage dtype; ``pos``
    the current position (a Python int)."""
    return flash_decode(q[:, 0], k_cache, v_cache, pos)[:, None]


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention weights (matmul layout)."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def gqa_init(cfg: ModelConfig, gen: torch.Generator, dtype) -> GQA:
    d, H, KH, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    qk = ((_ones(hd, dtype, gen.device), _ones(hd, dtype, gen.device))
          if cfg.qk_norm else (None, None))
    return GQA(_dense_init(gen, (d, H * hd), dtype, d),
               _dense_init(gen, (d, KH * hd), dtype, d),
               _dense_init(gen, (d, KH * hd), dtype, d),
               _dense_init(gen, (H * hd, d), dtype, H,
                           scale=1.0 / math.sqrt(H * hd)), *qk)


def gqa_apply(cfg: ModelConfig, p: GQA, x, positions, *,
              cache: Optional[Dict] = None, pos: Optional[int] = None):
    """x: (B,S,d).  Train/prefill when ``pos`` is None (the prefix is
    written into ``cache`` when one is given); decode when x has S == 1
    and ``cache``/``pos`` are given.  Returns (y, cache)."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq).view(B, S, H, hd)
    k = (x @ p.wk).view(B, S, KH, hd)
    v = (x @ p.wv).view(B, S, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None and pos is not None:
        # decode: the JAX package inserts the new k/v with a functional
        # dynamic_update_slice; the port writes the cache in place
        cache["k"][:, pos:pos + 1] = k
        cache["v"][:, pos:pos + 1] = v
        out = cached_decode_attention(q, cache["k"], cache["v"], pos)
    else:
        out = blocked_causal_attention(q, k, v, cfg.attn_chunk)
        if cache is not None:  # prefill: write the whole prefix in place
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    y = out.reshape(B, S, H * hd) @ p.wo
    return y, cache


def gqa_cache_init(cfg: ModelConfig, batch, max_seq, dtype, device):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def mlp_init(cfg: ModelConfig, gen: torch.Generator, dtype,
             d_ff=None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return MLP(_dense_init(gen, (d, f), dtype, d),
               _dense_init(gen, (d, f), dtype, d),
               _dense_init(gen, (f, d), dtype, f))


def mlp_apply(cfg: ModelConfig, p: MLP, x):
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# Mamba1 block (selective scan)
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    """Mamba1 weights, in the JAX package's layouts: ``in_proj`` (d, 2di),
    ``conv_w`` (dc, di), ``conv_b`` (di,), ``x_proj`` (di, dtr + 2ds),
    ``dt_proj`` (dtr, di), ``dt_bias`` (di,), ``A_log`` (di, ds) and ``D``
    (di,) in float32, ``out_proj`` (di, d)."""

    NAMES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
             "A_log", "D", "out_proj")

    def __init__(self, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias,
                 A_log, D, out_proj):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = in_proj, conv_w, conv_b
        self.x_proj, self.dt_proj, self.dt_bias = x_proj, dt_proj, dt_bias
        self.A_log, self.D, self.out_proj = A_log, D, out_proj


def mamba_init(cfg: ModelConfig, gen: torch.Generator, dtype) -> Mamba:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = cfg.resolved_dt_rank
    dev = gen.device
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return Mamba(
        _dense_init(gen, (d, 2 * di), dtype, d),
        _dense_init(gen, (dc, di), dtype, dc, scale=1.0 / math.sqrt(dc)),
        _frozen(torch.zeros(di, dtype=dtype, device=dev)),
        _dense_init(gen, (di, dtr + 2 * ds), dtype, di),
        _dense_init(gen, (dtr, di), dtype, dtr),
        # softplus^-1(0.01)
        _frozen(torch.full((di,), -4.6, dtype=dtype, device=dev)),
        _frozen(torch.log(A).repeat(di, 1)),
        _ones(di, torch.float32, dev),
        _dense_init(gen, (di, d), dtype, di))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,di); w: (dc,di); state: (B,dc-1,di)
    or None (zeros).  The sum of dc shifted products, as the JAX package
    rounds it.  Returns (y, the last dc-1 rows of the padded input)."""
    dc = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, dc - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(dc))
    new_state = xp[:, xp.shape[1] - (dc - 1):, :] if dc > 1 else None
    return y + b, new_state


def _ssm_scan_chunked(a, b, C, h0, chunk):
    """h_t = a_t * h_{t-1} + b_t ; y_t = sum_s C_t[s] h_t[:,s].
    a,b: (B,S,di,ds); C: (B,S,ds); h0: (B,di,ds), all float32 -> y
    (B,S,di), h_final (B,di,ds).  ``chunk`` is the JAX schedule's block
    length; the kernel carries the state over the whole sequence."""
    del chunk
    # C is a column slice of the x_proj output (a view in float32)
    return selective_scan(a.contiguous(), b.contiguous(), C.contiguous(),
                          h0.contiguous())


def mamba_apply(cfg: ModelConfig, p: Mamba, x, cache: Optional[Dict] = None,
                decode: bool = False):
    """x: (B,S,d).  Train/prefill (``decode`` False: the scan from the
    cache's h, or zeros, and a zero-padded conv) or one decode step (S ==
    1, ``cache`` = {"h", "conv"}).  Returns (y, new cache or None)."""
    B, S, _ = x.shape
    di, ds = cfg.d_inner, cfg.ssm.d_state
    dtr = cfg.resolved_dt_rank
    xz = x @ p.in_proj
    xin, z = xz[..., :di], xz[..., di:]
    conv_state = cache.get("conv") if cache else None
    xc, new_conv = _causal_conv(xin, p.conv_w, p.conv_b,
                                state=conv_state if decode else None)
    xc = F.silu(xc)
    proj = xc @ p.x_proj
    dt = F.softplus(proj[..., :dtr] @ p.dt_proj + p.dt_bias)
    Bmat = proj[..., dtr:dtr + ds].float()                  # (B,S,ds)
    Cmat = proj[..., dtr + ds:].float()
    A = -torch.exp(p.A_log)                                 # (di,ds)
    dt32 = dt.float()
    a = torch.exp(dt32[..., None] * A)                      # (B,S,di,ds)
    b = (dt32 * xc.float())[..., None] * Bmat[:, :, None, :]
    if decode:
        h = a[:, 0] * cache["h"] + b[:, 0]
        y = torch.einsum("bds,bs->bd", h, Cmat[:, 0])[:, None, :]
        new_h = h
    else:
        h0 = (cache["h"] if cache is not None
              else torch.zeros((B, di, ds), dtype=torch.float32,
                               device=x.device))
        y, new_h = _ssm_scan_chunked(a, b, Cmat, h0, cfg.scan_chunk)
    y = y.to(x.dtype) + xc * p.D.to(x.dtype)
    y = y * F.silu(z)
    out = y @ p.out_proj
    new_cache = None
    if cache is not None:
        new_cache = {"h": new_h}
        if new_conv is not None:
            new_cache["conv"] = (new_conv.to(cache["conv"].dtype)
                                 if "conv" in cache else new_conv)
        elif "conv" in cache:
            new_cache["conv"] = cache["conv"]
    return out, new_cache


def mamba_cache_init(cfg: ModelConfig, batch, dtype, device):
    """{"h": (batch, di, ds) float32, "conv": (batch, dc-1, di) in
    ``dtype``} of zeros; no "conv" when dc == 1."""
    di, ds, dc = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    c = {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                          device=device)}
    if dc > 1:
        c["conv"] = torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device)
    return c


# ---------------------------------------------------------------------------
# later slices of the port
# ---------------------------------------------------------------------------

def _later(what: str, item: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not ported to PyTorch yet ({item} of ROADMAP.md)")
    return missing


mla_init = mla_apply = mla_cache_init = _later(
    "MLA attention", "Queue A item 5")
moe_init = moe_apply = _later("the MoE layer", "Queue A item 5")
