"""Model layers: RMSNorm, RoPE, causal attention (prefill) and cached
single-token attention (decode), the GQA and MLA attention layers, the
SwiGLU MLP, the token-dropping MoE layer and the Mamba1 block.  A PyTorch
port of the JAX package's ``models/layers.py``, with its numerics.

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

MLA (deepseek-v2) keeps ``wq`` (d, H*(nope+rope)), ``wkv_a`` (d,
R+rope), ``kv_norm`` (R,), ``wkv_b`` (R, H*(nope+v)) and ``wo`` (H*v, d)
in the same layout and caches the compressed ``ckv`` (B, Smax, R) and the
shared rotated key ``krope`` (B, Smax, rope).  Its prefill expands the
keys and values per head and runs the shared causal core with q and k at
head dim nope + rope = 192 and v at its own width (128), hence
``flash_attention`` (the JAX package pads v to 192 and slices the output
back, which gives the same values); its
decode step stays in the latent space (the absorbed path) in plain
products with float32 results, as the JAX package computes it outside
any Pallas kernel.

The MoE layer keeps the JAX package's layouts: a float32 ``router`` (d,
E), stacked experts ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f,
d), and an optional ``shared`` MLP.  Dispatch drops tokens past each
expert's capacity exactly as the JAX package does (top-k of the float32
softmax, sorted descending, renormalised gates, an exclusive cumsum over
(token, choice) order, a pad slot at E*C); the expert products are
batched ``torch.bmm``, as the JAX package leaves them to XLA.

The Mamba1 block (falcon-mamba) keeps the JAX package's parameter names
and layouts; its discretisation and scan (prefill, and training, where
autograd records the kernel's backward) go through the fused hand-written
CUDA kernels of ``kernels/mamba_scan`` (``selective_scan_fused``), and its
decode step is one recurrence step in plain ops, as in the JAX package.

Sharded runs: the ``res`` of ``parallel/collectives.py`` gives a rank
of a model split over the mesh's "model" axis (a layer never sees a
weight split over "data": ``models/transformer.py`` gathers it first).
A layer reads its local widths from its weights (heads, kv heads,
experts, ``d_inner``) and, where
its weights split a product's contraction, adds the ranks' partial sums
with ``res.all_reduce``: after ``wo``, ``w_down``, the experts' combine,
and Mamba's ``x_proj`` and ``out_proj``.  The same widths say where a
tensor equal on every rank meets the rank's block, which ``res.enter``
marks for the backward: the input of GQA, MLA's ``wq``, the MLP and
Mamba's ``in_proj``; MLA's compressed ``ckv`` and rotated key; the MoE
layer's tokens and gates into the rank's experts; the ``dt``, B and C
that leave Mamba's all-reduced ``x_proj``; qwen3's q/k norm weights.
A cache entry that the resolver splits by positions (``res.kv_stretch``
of its logical axes and whole shape) holds the rank's stretch of them:
the attention layers write only the positions that fall in it, and a
decode step combines each rank's partial over its live rows
(``flash_decode_partial`` for GQA, the absorbed decode's plain products
for MLA, after an all-gather of its latent queries over heads) with
``res.combine_lse``.  Under a training batch whose positions the
resolver splits over "data" (``res.stretch``) a layer sees the rank's
stretch of positions: attention gathers the keys and values up to its
end (MLA its latent rows) and runs ``flash_attention`` with ``q_start``,
Mamba takes its conv's halo and its scan's initial state from the
earlier stretches, and the MoE dispatch counts their slots.  With
``res`` None a layer runs as on one card.

Attention keeps its scores in ``cfg.score_dtype``: float32, or bfloat16
as the JAX package's ``_flash_inner`` rounds them (both kernels and
their plain versions take it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_decode.kernel import (flash_decode,
                                                    flash_decode_partial)
from repro_torch.kernels.mamba_scan.kernel import (selective_scan,
                                                  selective_scan_fused)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _same(x):
    """``res.enter``'s stand-in where nothing is split."""
    return x


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

def blocked_causal_attention(q, k, v, chunk: int = 2048,
                             score_dtype="float32", q_start: int = 0):
    """Exact causal attention. q: (B,S,H,D); k: (B,q_start+S,KH,D); v:
    (B,q_start+S,KH,D_v), D_v <= D -> (B,S,H,D_v); query row i at key
    position ``q_start`` + i.  ``chunk`` is the JAX schedule's kv-block
    size, against whose running max the plain version rounds bfloat16
    scores (``score_dtype``); the kernel picks its own tiles and takes
    any S, and neither changes the result beyond rounding."""
    return flash_attention(q, k, v, q_start=q_start,
                           score_dtype=score_dtype, chunk=chunk)


def cached_decode_attention(q, k_cache, v_cache, pos: int):
    """Single-token attention over a static-size cache.
    q: (B,1,H,D); caches: (B,Smax,KH,D) in their storage dtype; ``pos``
    the current position (a Python int)."""
    return flash_decode(q[:, 0], k_cache, v_cache, pos)[:, None]


# ---------------------------------------------------------------------------
# caches split by positions across ranks
# ---------------------------------------------------------------------------

def _kv_stretch(res, cache, axes, whole):
    """The rank's stretch (first position, length) of a layer's cache,
    asked of ``res.kv_stretch`` with an entry's logical axes and whole
    shape; None with no cache or ``res``, or where every rank holds every
    position."""
    return (None if cache is None or res is None
            else res.kv_stretch(axes, whole))


def _write_prefix(cache, rows, S: int, stretch):
    """Prefill: each entry's positions [0, S) from ``rows`` in place; of
    a stretch (start, n), its positions [start, start + n) that the
    prompt reaches, at its rows from 0."""
    for k, t in rows.items():
        if stretch is None:
            cache[k][:, :S] = t
            continue
        start, n = stretch
        hi = min(S, start + n)
        if hi > start:
            cache[k][:, :hi - start] = t[:, start:hi]


def _write_row(cache, rows, pos: int, stretch):
    """Decode: each entry's position ``pos`` in place; of a stretch, only
    by the rank whose stretch holds it."""
    start, n = stretch if stretch is not None else (0, pos + 1)
    if start <= pos < start + n:
        for k, t in rows.items():
            cache[k][:, pos - start:pos - start + 1] = t


def _live(pos: int, stretch) -> int:
    """The rows of a stretch at or before ``pos`` (0 for a stretch that
    starts past it)."""
    start, n = stretch
    return min(max(pos + 1 - start, 0), n)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention weights (matmul layout).  ``AXES``: each
    weight's logical axes in the JAX package's layout ((d, H, hd) for
    ``wq``), which ``transformer.param_axes`` hands to the resolver."""

    AXES = {"wq": ("d_model", "heads", None),
            "wk": ("d_model", "kv_heads", None),
            "wv": ("d_model", "kv_heads", None),
            "wo": ("heads", None, "d_model"),
            "q_norm": (None,), "k_norm": (None,)}

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
              cache: Optional[Dict] = None, pos: Optional[int] = None,
              res=None, max_seq: Optional[int] = None):
    """x: (B,S,d).  Train/prefill when ``pos`` is None (the prefix is
    written into ``cache`` when one is given); decode when x has S == 1
    and ``cache``/``pos`` are given.  The heads are the weights' (a
    rank's block of them under ``res``).  Under ``res`` a cache of whole
    length ``max_seq`` that the resolver splits by positions holds the
    rank's stretch: the prefill writes the part the prompt reaches, a
    decode step writes ``pos`` on the rank that holds it, and each rank's
    partial over its live rows is combined across ranks.  Returns (y,
    cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KH = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    split = res is not None and H < cfg.n_heads
    enter = res.enter if split else _same
    x = enter(x)
    q = (x @ p.wq).view(B, S, H, hd)
    k = (x @ p.wk).view(B, S, KH, hd)
    v = (x @ p.wv).view(B, S, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, enter(p.q_norm), cfg.norm_eps)
        k = rmsnorm(k, enter(p.k_norm), cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    seq = None if res is None or cache is not None else res.stretch
    stretch = _kv_stretch(res, cache, GQA_CACHE_AXES["k"],
                          (B, max_seq, cfg.n_kv_heads, hd))
    if cache is not None and pos is not None:
        # decode: the JAX package inserts the new k/v with a functional
        # dynamic_update_slice; the port writes the cache in place
        _write_row(cache, {"k": k, "v": v}, pos, stretch)
        if stretch is None:
            out = cached_decode_attention(q, cache["k"], cache["v"], pos)
        else:
            o, lse = flash_decode_partial(q[:, 0], cache["k"], cache["v"],
                                          _live(pos, stretch))
            out = res.combine_lse(o, lse, q.dtype)[:, None]
    elif seq is not None:
        # the rank's stretch of positions against the keys up to its end
        kv = res.seq_gather(torch.cat([k, v], dim=-1), 1)[:, :sum(seq)]
        out = blocked_causal_attention(q, kv[..., :hd].contiguous(),
                                       kv[..., hd:].contiguous(),
                                       cfg.attn_chunk, cfg.score_dtype,
                                       q_start=seq[0])
    else:
        out = blocked_causal_attention(q, k, v, cfg.attn_chunk,
                                       cfg.score_dtype)
        if cache is not None:  # prefill: write the prefix in place
            _write_prefix(cache, {"k": k, "v": v}, S, stretch)
    y = out.reshape(B, S, H * hd) @ p.wo
    if split:
        y = res.all_reduce(y)
    return y, cache


GQA_CACHE_AXES = {"k": ("batch", "kv_seq", "kv_heads", None),
                  "v": ("batch", "kv_seq", "kv_heads", None)}


def gqa_cache_init(cfg: ModelConfig, batch, max_seq, dtype, device):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): compressed kv cache, absorbed decode path
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Multi-head latent attention weights (matmul layout); ``AXES`` as
    :class:`GQA`'s."""

    AXES = {"wq": ("d_model", "heads", None),
            "wkv_a": ("d_model", "kv_lora"),
            "kv_norm": (None,),
            "wkv_b": ("kv_lora", "heads", None),
            "wo": ("heads", None, "d_model")}

    def __init__(self, wq, wkv_a, kv_norm, wkv_b, wo):
        super().__init__()
        self.wq, self.wkv_a, self.kv_norm = wq, wkv_a, kv_norm
        self.wkv_b, self.wo = wkv_b, wo


def mla_init(cfg: ModelConfig, gen: torch.Generator, dtype) -> MLA:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.nope_head_dim + m.rope_head_dim
    R = m.kv_lora_rank
    return MLA(_dense_init(gen, (d, H * qk_dim), dtype, d),
               _dense_init(gen, (d, R + m.rope_head_dim), dtype, d),
               _ones(R, dtype, gen.device),
               _dense_init(gen, (R, H * (m.nope_head_dim + m.v_head_dim)),
                           dtype, R),
               _dense_init(gen, (H * m.v_head_dim, d), dtype, H,
                           scale=1.0 / math.sqrt(H * m.v_head_dim)))


def _f32_einsum(eq, *xs):
    """``jnp.einsum(..., preferred_element_type=float32)`` of the JAX
    package's absorbed decode: the products and their sums in float32,
    whatever the operands' dtype (a bfloat16 ``torch.matmul`` would round
    its output to bfloat16)."""
    return torch.einsum(eq, *(x.float() for x in xs))


def _mla_attend(q_lat, q_rope, ckv, krope, scale):
    """The absorbed decode's attention over the latent rows it is given:
    q_lat (B,1,H,R) and q_rope (B,1,H,rope) in the cache's dtype, ckv
    (B,t,R) and krope (B,t,rope) -> (o_lat (B,1,H,R) float32, the scaled
    scores (B,H,1,t) float32)."""
    s = _f32_einsum("bshr,btr->bhst", q_lat, ckv)
    s = s + _f32_einsum("bshk,btk->bhst", q_rope, krope)
    s = s * scale
    w = torch.softmax(s, dim=-1)
    return _f32_einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv), s


def mla_apply(cfg: ModelConfig, p: MLA, x, positions, *,
              cache: Optional[Dict] = None, pos: Optional[int] = None,
              res=None, max_seq: Optional[int] = None):
    """x: (B,S,d).  Train/prefill (the expanded path; the compressed
    prefix is written into ``cache`` in place when one is given) or one
    decode step (S == 1 with ``cache``/``pos``: the absorbed path over
    the cache's first ``pos`` + 1 rows).  The heads are the weights' (a
    rank's block of ``wq``'s and ``wkv_b``'s columns and ``wo``'s rows
    under ``res``, ``wkv_a`` and ``kv_norm`` whole, an all-reduce after
    ``wo``).  Under ``res`` a cache of whole length ``max_seq`` that the
    resolver splits by positions holds the rank's stretch of ``ckv`` and
    ``krope``: the absorbed decode gathers every head's latent queries,
    scores them over the rank's live rows, combines the ranks' partials
    and takes the rank's heads on.  Returns (y, cache)."""
    m = cfg.mla
    B, S, _ = x.shape
    R = m.kv_lora_rank
    nope, rope_d, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    H = p.wq.shape[1] // (nope + rope_d)
    split = res is not None and H < cfg.n_heads
    enter = res.enter if split else _same
    q = (enter(x) @ p.wq).view(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = x @ p.wkv_a
    ckv = rmsnorm(kv_a[..., :R], p.kv_norm, cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(kv_a[..., None, R:], cos, sin)[..., 0, :]

    # krope's positions split as ckv's: no other dim of either takes the
    # "model" axis
    stretch = _kv_stretch(res, cache, MLA_CACHE_AXES["ckv"], (B, max_seq, R))
    seq = None if res is None or cache is not None else res.stretch
    if cache is not None and pos is not None and S == 1:
        # absorbed decode: never expand the per-token K/V.  The JAX
        # package inserts with a functional dynamic_update_slice and masks
        # the rows past pos; the port writes the cache in place and reads
        # its live prefix (the masked rows add exact zeros)
        _write_row(cache, {"ckv": ckv, "krope": k_rope}, pos, stretch)
        live = pos + 1 if stretch is None else _live(pos, stretch)
        ckv_c = cache["ckv"][:, :live]
        kr_c = cache["krope"][:, :live]
        wkv_b = p.wkv_b.view(R, H, nope + vd)
        q_lat = _f32_einsum("bshk,rhk->bshr", q_nope, wkv_b[..., :nope])
        scale = 1.0 / math.sqrt(nope + rope_d)
        if stretch is None:
            o_lat, _ = _mla_attend(q_lat.to(ckv_c.dtype),
                                   q_rope.to(kr_c.dtype), ckv_c, kr_c, scale)
        else:
            # every head's queries meet the rank's stretch of positions
            qq = torch.cat([q_lat.to(ckv_c.dtype), q_rope.to(kr_c.dtype)],
                           dim=-1)
            if split:
                qq = res.all_gather(qq, 2)
            o_lat, s = _mla_attend(qq[..., :R], qq[..., R:], ckv_c, kr_c,
                                   scale)
            # each head's log-sum-exp, -inf with no live row: (B,1,H)
            lse = torch.logsumexp(s, dim=-1).transpose(1, 2)
            o_lat = res.combine_lse(o_lat, lse)
            if split:
                o_lat = o_lat[:, :, res.rank * H:(res.rank + 1) * H]
        out = _f32_einsum("bshr,rhv->bshv", o_lat.to(wkv_b.dtype),
                          wkv_b[..., nope:]).to(x.dtype)
    else:
        # expanded path: per-head keys and values, the shared causal core
        # with q and k at head dim nope + rope and v at its own vd columns.
        # Under a stretch of positions the latent rows (kv_lora + rope
        # columns) are gathered up to its end, then expanded
        q_start = 0
        if seq is not None:
            q_start = seq[0]
            lat = res.seq_gather(torch.cat([ckv, k_rope], dim=-1),
                                 1)[:, :sum(seq)]
            ckv, k_rope = lat[..., :R], lat[..., R:]
        Sk = ckv.shape[1]
        kv = (enter(ckv) @ p.wkv_b).view(B, Sk, H, nope + vd)
        k = torch.cat([kv[..., :nope],
                       enter(k_rope)[:, :, None, :].expand(B, Sk, H,
                                                           rope_d)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = blocked_causal_attention(qq, k, kv[..., nope:].contiguous(),
                                       cfg.attn_chunk, cfg.score_dtype,
                                       q_start=q_start)
        if cache is not None:  # prefill: write the prefix in place
            _write_prefix(cache, {"ckv": ckv, "krope": k_rope}, S, stretch)
    y = out.reshape(B, S, H * vd) @ p.wo
    if split:
        y = res.all_reduce(y)
    return y, cache


MLA_CACHE_AXES = {"ckv": ("batch", "kv_seq", "kv_lora"),
                  "krope": ("batch", "kv_seq", None)}


def mla_cache_init(cfg: ModelConfig, batch, max_seq, dtype, device):
    """{"ckv": (batch, max_seq, R), "krope": (batch, max_seq, rope)} of
    zeros in ``dtype``."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, m.rope_head_dim),
                                 dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    AXES = {"w_gate": ("d_model", "d_ff"), "w_up": ("d_model", "d_ff"),
            "w_down": ("d_ff", "d_model")}

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def mlp_init(cfg: ModelConfig, gen: torch.Generator, dtype,
             d_ff=None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return MLP(_dense_init(gen, (d, f), dtype, d),
               _dense_init(gen, (d, f), dtype, d),
               _dense_init(gen, (f, d), dtype, f))


def mlp_apply(cfg: ModelConfig, p: MLP, x, res=None, d_ff=None):
    """``d_ff`` as in :func:`mlp_init` (``cfg.d_ff`` unless given): a
    narrower ``w_down`` is a rank's block of it, all-reduced after."""
    split = res is not None and p.w_down.shape[0] < (d_ff or cfg.d_ff)
    if split:
        x = res.enter(x)
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    y = h @ p.w_down
    if split:
        y = res.all_reduce(y)
    return y


# ---------------------------------------------------------------------------
# MoE: top-k router + capacity dispatch (token dropping)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """Routed experts in the JAX package's layouts: ``router`` (d, E)
    float32, ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d), and
    ``shared`` (an :class:`MLP` of n_shared * f) or None."""

    NAMES = ("router", "w_gate", "w_up", "w_down")
    # the router stays replicated on the model axis, as the JAX package
    # keeps it
    AXES = {"router": ("d_model", None),
            "w_gate": ("experts", "d_model", "d_ff"),
            "w_up": ("experts", "d_model", "d_ff"),
            "w_down": ("experts", "d_ff", "d_model")}

    def __init__(self, router, w_gate, w_up, w_down, shared=None):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
        self.shared = shared


def moe_init(cfg: ModelConfig, gen: torch.Generator, dtype) -> MoE:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.moe.n_routed
    shared = (mlp_init(cfg, gen, dtype, d_ff=cfg.moe.n_shared * f)
              if cfg.moe.n_shared else None)
    return MoE(_dense_init(gen, (d, E), torch.float32, d),
               _dense_init(gen, (E, d, f), dtype, d),
               _dense_init(gen, (E, d, f), dtype, d),
               _dense_init(gen, (E, f, d), dtype, f), shared)


def moe_route(cfg: ModelConfig, p: MoE, x):
    """The router: x (..., d) -> (probs (..., E) float32 softmax of the
    float32 logits, gates (..., k) the top-k probabilities renormalised,
    gate_idx (..., k) their experts, descending)."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    E, k = cfg.moe.n_routed, cfg.moe.top_k
    return int(max(1, math.ceil(cfg.moe.capacity_factor * k * n_tokens / E)))


def _expert_counts(gate_idx, E: int):
    """int32 (G, E): each group's choices of each expert, gate_idx (G, T,
    k)."""
    G = gate_idx.shape[0]
    idx = gate_idx.reshape(G, -1)
    return torch.zeros((G, E), dtype=torch.int32,
                       device=idx.device).scatter_add_(
        1, idx, torch.ones(idx.shape, dtype=torch.int32, device=idx.device))


def _dispatch(cfg: ModelConfig, p: MoE, x, gate_vals, gate_idx, C,
              e0: int = 0, offset=None):
    """Capacity dispatch within each group (leading dim G of x (G, T, d)
    and of gate_vals/gate_idx (G, T, k)): slot = the choice's exclusive
    running count of its expert over (token, choice) order, plus the
    group's ``offset`` (G, E) of that expert (the choices of the tokens
    that precede the group's on other ranks) when given; choices at
    slot >= C are dropped (sent to the pad row, never read back).
    The experts run on their (G*C, d) rows as three batched products;
    returns the gate-weighted sum over each token's kept choices, (G, T,
    d) in x's dtype.  The experts are ``p``'s, from expert ``e0`` on (a
    rank's block of them): the slots are counted over all E, as on one
    card, and a choice of another rank's expert adds nothing here."""
    G, T, d = x.shape
    E, k = cfg.moe.n_routed, cfg.moe.top_k
    El = p.w_gate.shape[0]
    flat_idx = gate_idx.reshape(G, T * k)
    onehot = F.one_hot(flat_idx, E)                        # (G, T*k, E)
    pos_in_e = onehot.cumsum(dim=1) - onehot               # exclusive
    slot = pos_in_e.gather(2, flat_idx[..., None])[..., 0]
    if offset is not None:
        slot = slot + offset.to(slot.dtype).gather(1, flat_idx)
    keep = slot < C
    if El < E:
        flat_idx = flat_idx - e0
        keep = keep & (flat_idx >= 0) & (flat_idx < El)
    dest = torch.where(keep, flat_idx * C + slot,
                       torch.full_like(flat_idx, El * C))
    buf = x.new_zeros((G, El * C + 1, d))
    # distinct rows but for the pad row, whose contents are discarded
    buf.scatter_(1, dest[..., None].expand(G, T * k, d),
                 x.repeat_interleave(k, dim=1))
    xe = buf[:, :El * C].view(G, El, C, d).transpose(0, 1).reshape(
        El, G * C, d)
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    out_e = torch.bmm(h, p.w_down)                          # (El, G*C, d)
    out_b = out_e.view(El, G, C, d).transpose(0, 1).reshape(G, El * C, d)
    safe = dest.clamp_max(El * C - 1)
    gathered = out_b.gather(1, safe[..., None].expand(G, T * k, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return (gathered.view(G, T, k, d)
            * gate_vals[..., None].to(x.dtype)).sum(dim=2)


def _moe_global_dispatch(cfg: ModelConfig, p: MoE, x, e0: int = 0,
                         enter=_same, res=None):
    """The whole batch as one group of B*S tokens (the JAX package's
    naive scatter).  ``enter`` marks the tokens and gates that reach the
    rank's experts.  Where other ranks hold other tokens of the batch
    (``res.token_sum``'s ranks) x is the rank's part and the slots count
    the choices of every token before it in the whole batch's (token,
    choice) order: one all-gather of each rank's counts a (row, expert)
    gives them (rows split: the earlier ranks' rows come first; positions
    split over "data": each row's earlier rows whole and its earlier
    stretches), and C is the whole batch's.  Returns (y (B,S,d), probs
    (B*S, E), gate_idx (B*S, k))."""
    B, S, d = x.shape
    E = cfg.moe.n_routed
    if res is None or res.token_group() is None:
        xt = x.reshape(1, B * S, d)
        probs, gate_vals, gate_idx = moe_route(cfg, p, xt)
        y = _dispatch(cfg, p, enter(xt), enter(gate_vals), gate_idx,
                      _capacity(cfg, B * S), e0)
        return (y.view(B, S, d), probs.view(B * S, -1),
                gate_idx.view(B * S, -1))
    probs, gate_vals, gate_idx = moe_route(cfg, p, x)      # (B, S, .)
    counts, i = res.gather_counts(_expert_counts(gate_idx, E))  # (n,B,E)
    C = _capacity(cfg, counts.shape[0] * B * S)
    if res.stretch is not None:   # each row a group after its earlier rows
        rows = counts.sum(0)
        offset = rows.cumsum(0) - rows + counts[:i].sum(0)
        y = _dispatch(cfg, p, enter(x), enter(gate_vals), gate_idx, C, e0,
                      offset)
    else:                         # the rank's rows one group, after others'
        offset = counts[:i].sum((0, 1))[None]
        y = _dispatch(cfg, p, enter(x.reshape(1, B * S, d)),
                      enter(gate_vals.reshape(1, B * S, -1)),
                      gate_idx.reshape(1, B * S, -1), C, e0,
                      offset).view(B, S, d)
    return y, probs.reshape(B * S, -1), gate_idx.reshape(B * S, -1)


def _moe_grouped_dispatch(cfg: ModelConfig, p: MoE, x, e0: int = 0,
                          enter=_same, res=None):
    """Each batch row a group of S tokens (GShard-style: the position
    cumsum, scatter and combine stay local to the row); ``enter`` as in
    :func:`_moe_global_dispatch`.  Where "data" splits the positions, a
    row's slots count its earlier stretches' choices too (one all-gather
    of the ranks' counts a (row, expert)) and C is the whole row's.
    Returns (y (B,S,d), probs (B*S, E), gate_idx (B*S, k))."""
    B, S, d = x.shape
    probs, gate_vals, gate_idx = moe_route(cfg, p, x)
    C, offset = _capacity(cfg, S), None
    if res is not None and res.stretch is not None:
        counts, i = res.gather_counts(_expert_counts(gate_idx,
                                                     cfg.moe.n_routed))
        C, offset = _capacity(cfg, counts.shape[0] * S), counts[:i].sum(0)
    y = _dispatch(cfg, p, enter(x), enter(gate_vals), gate_idx, C, e0,
                  offset)
    return y, probs.view(B * S, -1), gate_idx.view(B * S, -1)


def moe_apply(cfg: ModelConfig, p: MoE, x, res=None):
    """x: (B,S,d) -> (y (B,S,d), aux): token-dropping capacity MoE, plus
    the shared MLP, with the Switch-style load-balancing loss E *
    sum_e(density_e * mean_prob_e) in float32.  Under ``res`` the router
    (replicated) routes every token over all E experts on every rank,
    each rank runs its block of the experts, and one all-reduce adds the
    ranks' gate-weighted sums.  Where "data" splits the batch, x is the
    rank's rows and the aux's means are over every row: its counts and
    probabilities are summed over the ranks that hold other tokens
    before they are divided (``res.token_sum``); the capacity dispatch
    counts the slots of the tokens before the rank's on those ranks
    (:func:`_moe_grouped_dispatch`, :func:`_moe_global_dispatch`)."""
    E, (El, _, f) = cfg.moe.n_routed, p.w_gate.shape
    e0 = res.rank * El if res is not None and El < E else 0
    split = res is not None and (El < E or f < cfg.moe_d_ff)
    enter = res.enter if split else _same
    over_data = res is not None and res.token_group() is not None
    dispatch = (_moe_grouped_dispatch if cfg.moe.dispatch == "grouped"
                else _moe_global_dispatch)
    y, probs, gate_idx = dispatch(cfg, p, x, e0, enter, res)
    if split:
        y = res.all_reduce(y)
    if p.shared is not None:
        y = y + mlp_apply(cfg, p.shared, x, res,
                          d_ff=cfg.moe.n_shared * cfg.moe_d_ff)
    if over_data:
        # the means over every token of the batch: the rank's sums of
        # the choices, the probabilities and the tokens, summed over
        # "data" (whose backward passes the rank's part through)
        n = probs.new_full((1,), float(probs.shape[0]))
        tot = res.token_sum(torch.cat([
            F.one_hot(gate_idx, E).float().sum(dim=(0, 1)),
            probs.sum(dim=0), n]))
        density = tot[:E] / (tot[-1] * gate_idx.shape[-1])
        aux = E * (density * (tot[E:2 * E] / tot[-1])).sum()
        return y, aux
    density = F.one_hot(gate_idx, E).float().mean(dim=(0, 1))
    aux = E * (density * probs.mean(dim=0)).sum()
    return y, aux


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
    AXES = {"in_proj": ("d_model", "d_inner"), "conv_w": ("conv", "d_inner"),
            "conv_b": ("d_inner",), "x_proj": ("d_inner", None),
            "dt_proj": ("dt_rank", "d_inner"), "dt_bias": ("d_inner",),
            "A_log": ("d_inner", None), "D": ("d_inner",),
            "out_proj": ("d_inner", "d_model")}

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
                decode: bool = False, res=None):
    """x: (B,S,d).  Train/prefill (``decode`` False: the scan from the
    cache's h, or zeros, and a zero-padded conv) or one decode step (S ==
    1, ``cache`` = {"h", "conv"}).  ``d_inner`` is the weights' (a rank's
    block of it under ``res``, whose ``x_proj`` output is then a partial
    sum over it, all-reduced before ``dt_proj``, B and C).  Under a
    batch whose positions are split over "data" (``res.stretch``, no
    cache) x is the rank's stretch: the conv's halo is the previous
    stretch's tail, and the scan starts from the state the earlier
    stretches end in.  Returns (y, new cache or None)."""
    B, S, _ = x.shape
    di, ds = p.D.shape[0], cfg.ssm.d_state
    dtr = cfg.resolved_dt_rank
    split = res is not None and di < cfg.d_inner
    seq = None if res is None or cache is not None else res.stretch
    if split:
        x = res.enter(x)
    xz = x @ p.in_proj
    xin, z = xz[..., :di], xz[..., di:]
    conv_state = cache.get("conv") if cache and decode else None
    if seq is not None and p.conv_w.shape[0] > 1:
        # the conv's halo: the previous stretch's last dc - 1 rows (zeros
        # before the first), from one all-gather of every stretch's tail
        h = p.conv_w.shape[0] - 1
        if S < h:
            raise ValueError(f"{cfg.name}: a stretch of {S} positions is "
                             f"shorter than the conv's halo of {h}")
        tails = F.pad(res.seq_gather(xin[:, S - h:], 1), (0, 0, h, 0))
        r = res.data_rank
        conv_state = tails[:, r * h:(r + 1) * h]
    xc, new_conv = _causal_conv(xin, p.conv_w, p.conv_b, state=conv_state)
    xc = F.silu(xc)
    proj = xc @ p.x_proj
    if split:      # whole on every rank; dt, B and C enter its d_inner
        proj = res.enter(res.all_reduce(proj))
    dt = F.softplus(proj[..., :dtr] @ p.dt_proj + p.dt_bias)
    Bmat = proj[..., dtr:dtr + ds].float()                  # (B,S,ds)
    Cmat = proj[..., dtr + ds:].float()
    A = -torch.exp(p.A_log)                                 # (di,ds)
    if decode:
        dt32 = dt.float()
        a = torch.exp(dt32[..., None] * A)                  # (B,1,di,ds)
        b = (dt32 * xc.float())[..., None] * Bmat[:, :, None, :]
        h = a[:, 0] * cache["h"] + b[:, 0]
        y = torch.einsum("bds,bs->bd", h, Cmat[:, 0])[:, None, :]
        new_h = h
    else:
        # the discretisation runs inside the scan (the fused kernel on a
        # card): no (B,S,di,ds) plane of a or b is formed
        h0 = cache["h"].contiguous() if cache is not None else None
        args = (dt.contiguous(), xc.contiguous(), A, Bmat.contiguous(),
                Cmat.contiguous())
        y, new_h = selective_scan_fused(*args, h0)
        if seq is not None:
            # the state entering the stretch: each earlier stretch's final
            # state from zeros, carried through the later ones' decays
            # exp(A sum(dt)) (every stretch's pair from one all-gather),
            # then the stretch's scan again from it.  Every rank runs both
            # scans (the first stretch from zeros joined to the gathered
            # pairs), so that every rank's backward reduce-scatters them
            decay = torch.exp(dt.float().sum(1)[..., None] * A)
            both = res.seq_gather(torch.stack([new_h, decay])[None], 0)
            h0 = both[0, 0] * 0
            for j in range(res.data_rank):
                h0 = both[j, 1] * h0 + both[j, 0]
            y, new_h = selective_scan_fused(*args, h0)
    y = y.to(x.dtype) + xc * p.D.to(x.dtype)
    y = y * F.silu(z)
    out = y @ p.out_proj
    if split:
        out = res.all_reduce(out)
    new_cache = None
    if cache is not None:
        new_cache = {"h": new_h}
        if new_conv is not None:
            new_cache["conv"] = (new_conv.to(cache["conv"].dtype)
                                 if "conv" in cache else new_conv)
        elif "conv" in cache:
            new_cache["conv"] = cache["conv"]
    return out, new_cache


MAMBA_CACHE_AXES = {"h": ("batch", "d_inner", None),
                    "conv": ("batch", None, "d_inner")}


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

