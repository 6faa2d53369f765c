"""Decoder LM of every family the JAX package covers: dense GQA
(llama3.2-1b, qwen3-32b, yi-9b, stablelm-3b), MoE with GQA or MLA
attention (dbrx-132b, deepseek-v2-lite-16b), pure Mamba1
(falcon-mamba-7b), the hybrid attention/Mamba period with MoE
(jamba-v0.1-52b) and the two modality frontends (internvl2-1b's
``vit_stub``, musicgen-large's ``encodec_stub``): ``embed -> layers ->
norm -> head``.  A PyTorch port of the JAX package's
``models/transformer.py``.

The JAX package stacks its layers' parameters over ``n_blocks`` and runs
them with ``lax.scan`` (rematerialised for training); the port keeps one
``nn.Module`` per layer and runs them in a plain Python loop, each layer
under ``torch.utils.checkpoint`` when the training forward rematerialises
(``cfg.remat_policy``; the JAX package's two-level grouping,
``_auto_groups``, changes memory only and is not ported yet).  Layer i's
mixer and MLP follow ``cfg.mixer_kind(i)`` and ``cfg.mlp_kind(i)``, as
the JAX package's ``_layer_init`` builds them: an attention (GQA or MLA)
or Mamba mixer; an MoE MLP, else a dense one when ``d_ff > 0``, else no
MLP and no second norm (falcon-mamba).  The JAX package's leading dense
layers (``pre_blocks``, deepseek's first) are the first entries of the
list, its stacked blocks the rest; it gives sub-layer i of every block
the kinds of layer ``first_dense + i``, which are those of the port's
plain index because the kinds repeat with the block's period.  An MoE
layer's auxiliary load-balancing loss is summed over the layers and
returned by :func:`forward`, as the JAX package returns it.  The cache
is a list with one entry per layer: a GQA layer's ``{"k", "v"}`` tensors
or an MLA layer's compressed ``{"ckv", "krope"}``, which prefill and
decode write in place, or a Mamba layer's ``{"h", "conv"}`` state, which
prefill and decode replace in the list.

Frontends, as the JAX package stubs them: ``vit_stub`` takes
precomputed patch embeddings (B, n, d) in place of the first n
positions' token embeddings; ``encodec_stub`` takes (B, S, CB) tokens of
CB codebooks, sums their embeddings (``embed`` is (CB, V, d)) and
predicts every codebook at each position (``lm_head`` (d, V*CB), logits
(..., CB, V)).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Cache = List[Dict[str, torch.Tensor]]
Logical = Tuple[Optional[str], ...]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is valid and its attention scores are kept in
    float32, as the attention kernels keep them."""
    cfg.validate()
    if cfg.attn_kind not in ("gqa", "mla", "none"):
        raise NotImplementedError(
            f"{cfg.name}: attention kind {cfg.attn_kind!r} (the port has "
            f"gqa, mla and none)")
    if cfg.score_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: score_dtype {cfg.score_dtype!r}; the attention "
            f"kernels keep their scores in float32")


class Layer(nn.Module):
    """One decoder layer: a GQA, MLA or Mamba mixer with its MLP (dense
    or MoE) and second norm, or the mixer alone (``ln2`` and ``mlp``
    None)."""

    AXES = {"ln1": ("d_model",), "ln2": ("d_model",)}

    def __init__(self, ln1, ln2, mixer, mlp):
        super().__init__()
        self.ln1, self.ln2 = ln1, ln2
        self.mixer, self.mlp = mixer, mlp


class LM(nn.Module):
    """Parameters of the decoder: ``embed`` (vocab, d), or (CB, vocab, d)
    with the ``encodec_stub`` frontend, ``layers``, ``final_norm`` and,
    unless the config ties it to ``embed``, ``lm_head`` (d, vocab), or
    (d, vocab*CB)."""

    AXES = {"embed": ("vocab", "d_model"), "final_norm": ("d_model",),
            "lm_head": ("d_model", "vocab")}

    def __init__(self, embed, layers, final_norm, lm_head=None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _codebooks(cfg: ModelConfig) -> int:
    """The ``encodec_stub`` frontend's codebooks, else 0."""
    return cfg.n_codebooks if cfg.frontend == "encodec_stub" else 0


def _layer_init(cfg: ModelConfig, i: int, gen: torch.Generator,
                dtype) -> Layer:
    """Layer i, as the JAX package's ``_layer_init`` builds it."""
    if cfg.mixer_kind(i) == "attn":
        mixer = (L.mla_init if cfg.attn_kind == "mla"
                 else L.gqa_init)(cfg, gen, dtype)
    else:
        mixer = L.mamba_init(cfg, gen, dtype)
    if cfg.mlp_kind(i) == "moe":
        mlp = L.moe_init(cfg, gen, dtype)
    elif cfg.d_ff > 0:
        mlp = L.mlp_init(cfg, gen, dtype)
    else:
        return Layer(L._ones(cfg.d_model, dtype, gen.device), None, mixer,
                     None)
    return Layer(L._ones(cfg.d_model, dtype, gen.device),
                 L._ones(cfg.d_model, dtype, gen.device), mixer, mlp)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """Random weights of the published shapes, in ``cfg.dtype``, on the
    generator's device.  ``torch.Generator`` and ``jax.random`` draw
    different numbers from one seed: ``models/convert.py`` carries the JAX
    package's weights over where the two must agree."""
    check_supported(cfg)
    dtype, dev = _dtype(cfg), generator.device
    V, d, cb = cfg.vocab_size, cfg.d_model, _codebooks(cfg)
    embed = L._dense_init(generator, (cb, V, d) if cb else (V, d), dtype,
                          V, scale=0.02)
    layers = [_layer_init(cfg, i, generator, dtype)
              for i in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else L._dense_init(
        generator, (d, V * max(cb, 1)), dtype, d)
    return LM(embed, layers, L._ones(d, dtype, dev), head)


def init_abstract(cfg: ModelConfig) -> LM:
    """The parameters' shapes and dtypes on the ``meta`` device: nothing
    is allocated."""
    return init_params(cfg, L.ABSTRACT)


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params), as the JAX package counts them:
    ``active`` discounts the routed experts to their activated fraction
    (top_k / n_routed) and drops the input embedding gather, for the
    6*N_active*D useful-FLOPs estimate.  Computed from
    :func:`init_abstract`."""
    params = init_abstract(cfg)
    total = sum(p.numel() for p in params.parameters())
    routed = sum(getattr(m, n).numel() for m in params.modules()
                 if isinstance(m, L.MoE)
                 for n in ("w_gate", "w_up", "w_down"))
    active = total
    if cfg.moe.n_routed:
        active = total - routed + routed * cfg.moe.top_k / cfg.moe.n_routed
    return total, int(active - params.embed.numel())


def param_axes(cfg: ModelConfig, params: LM) -> Dict[str, Logical]:
    """Logical sharding axes of every parameter, keyed by its
    ``named_parameters()`` name: the axes the JAX package's ``init_params``
    returns for the same array, in its layout (``wq`` (d, H, hd) is
    ("d_model", "heads", None) though the port holds it as (d, H*hd):
    :func:`logical_shape` gives the shape they belong to).  Each module's
    ``AXES`` names its own parameters; the JAX package's leading ``None``
    of a stacked block does not arise, the port keeping one module a
    layer."""
    out = {}
    for name, p in params.named_parameters():
        owner, _, leaf = name.rpartition(".")
        axes = type(params.get_submodule(owner)).AXES[leaf]
        if name == "embed" and _codebooks(cfg):  # (CB, V, d)
            axes = (None,) + axes
        out[name] = axes
    return out


def logical_shape(cfg: ModelConfig, axes: Logical, shape) -> Tuple[int, ...]:
    """The shape that ``axes`` describe, from the port's ``shape`` of the
    same tensor: a (heads, hd) pair that the port keeps flattened into
    one dim (``wq``'s H*hd, ``wo``'s leading H*v) is split again.  Only
    the heads are ever sharded in such a pair, and they are its outer
    factor, so a shard of the pair is a contiguous block of the flat dim."""
    shape = tuple(shape)
    if len(axes) == len(shape):
        return shape
    for i, a in enumerate(axes[:-1]):
        if a in ("heads", "kv_heads") and axes[i + 1] is None:
            n = cfg.n_heads if a == "heads" else cfg.n_kv_heads
            if len(axes) == len(shape) + 1 and shape[i] % n == 0:
                return shape[:i] + (n, shape[i] // n) + shape[i + 1:]
    raise ValueError(f"axes {axes} do not fit shape {shape}")


def cache_axes(cfg: ModelConfig, cache: Cache) -> List[Dict[str, Logical]]:
    """Logical axes of every cache entry, the list of dicts of
    :func:`init_cache` (the JAX package's ``init_cache`` axes, a layer's
    without the stacked blocks' leading ``None``)."""
    out = []
    for i, c in enumerate(cache):
        table = (L.MAMBA_CACHE_AXES if cfg.mixer_kind(i) == "mamba"
                 else L.MLA_CACHE_AXES if cfg.attn_kind == "mla"
                 else L.GQA_CACHE_AXES)
        out.append({k: table[k] for k in c})
    return out


def param_bytes(params: LM) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: LM, tokens, patches=None):
    """tokens: (B,S) int, or (B,S,CB) with the ``encodec_stub`` frontend
    (the codebooks' embeddings summed in order); with the ``vit_stub``
    frontend, ``patches`` (B,n,d) take the first n positions' places."""
    tokens = tokens.long()
    if _codebooks(cfg):
        x = params.embed[0][tokens[..., 0]]
        for cb in range(1, cfg.n_codebooks):
            x = x + params.embed[cb][tokens[..., cb]]
    else:
        x = params.embed[tokens]
    if cfg.frontend == "vit_stub" and patches is not None:
        n = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
    return x


def lm_head(cfg: ModelConfig, params: LM, x):
    """(..., d) -> logits (..., V), or (..., CB, V) with the
    ``encodec_stub`` frontend (a tied head reads the codebooks'
    embeddings as one (CB*V, d) table)."""
    if cfg.tie_embeddings:
        logits = x @ params.embed.reshape(-1, cfg.d_model).T
    else:
        logits = x @ params.lm_head
    if _codebooks(cfg):
        logits = logits.reshape(logits.shape[:-1]
                                + (cfg.n_codebooks, cfg.vocab_size))
    return logits


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, lp: Layer, x, positions, cache=None,
                 pos=None):
    """Returns (x, the layer's aux loss (float32; 0 but for an MoE
    layer), the layer's cache entry); decode when ``pos`` is given."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
    if isinstance(lp.mixer, L.Mamba):
        h, cache = L.mamba_apply(cfg, lp.mixer, h, cache=cache,
                                 decode=pos is not None)
    else:
        fn = L.mla_apply if isinstance(lp.mixer, L.MLA) else L.gqa_apply
        h, cache = fn(cfg, lp.mixer, h, positions, cache=cache, pos=pos)
    x = x + h
    if lp.mlp is not None:
        h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        if isinstance(lp.mlp, L.MoE):
            h, aux = L.moe_apply(cfg, lp.mlp, h)
        else:
            h = L.mlp_apply(cfg, lp.mlp, h)
        x = x + h
    return x, aux, cache


def _save_dots():
    """``context_fn`` of ``torch.utils.checkpoint`` for ``remat_policy``
    "dots": the matmuls' outputs are saved, the rest recomputed (the JAX
    package's ``checkpoint_dots``)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat_layer(cfg: ModelConfig, lp: Layer, x, positions):
    """One training layer, rematerialised as ``cfg.remat_policy`` says:
    "nothing" saves only the layer's input and recomputes the rest in
    the backward, "dots" also saves the matmul outputs.  Returns (x,
    the layer's aux loss)."""
    from torch.utils.checkpoint import checkpoint

    def body(x):
        return _apply_layer(cfg, lp, x, positions)[:2]
    if cfg.remat_policy == "dots":
        return checkpoint(body, x, use_reentrant=False,
                          context_fn=_save_dots)
    return checkpoint(body, x, use_reentrant=False)


def _run(cfg, params: LM, x, positions, cache=None, pos=None,
         remat: bool = False):
    """The layers and the final norm; returns (x, the summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.layers):
        if remat:
            x, a = _remat_layer(cfg, lp, x, positions)
        else:
            x, a, layer_cache = _apply_layer(
                cfg, lp, x, positions, None if cache is None else cache[i],
                pos)
            if cache is not None:
                cache[i] = layer_cache
        aux = aux + a
    return L.rmsnorm(x, params.final_norm, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: LM, tokens, *, patches=None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/scoring forward. tokens: (B,S) int (or (B,S,CB));
    ``patches`` (B,n,d) for the ``vit_stub`` frontend.  Returns (logits,
    aux_loss): the MoE layers' load-balancing losses summed (float32; 0.0
    without MoE layers).

    With ``remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (``use_reentrant=False``) unless
    ``cfg.remat_policy`` is "everything" or ``cfg.remat_inner`` is
    "none", as the JAX package checkpoints its scan body.  Checkpointing
    changes what the backward keeps, not the values."""
    x = embed_tokens(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = (remat and torch.is_grad_enabled()
             and cfg.remat_policy != "everything"
             and cfg.remat_inner != "none")
    x, aux = _run(cfg, params, x, positions, remat=remat)
    return lm_head(cfg, params, x), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Cache:
    """One zeroed cache per layer, in ``cfg.dtype``: ``{"k", "v"}`` of
    (batch, max_seq, KH, hd) for a GQA layer; ``{"ckv", "krope"}`` of
    (batch, max_seq, kv_lora_rank) and (batch, max_seq, rope_head_dim)
    for an MLA layer; ``{"h", "conv"}`` for a Mamba layer
    (``mamba_cache_init``: its size does not depend on ``max_seq``),
    each layer's as its mixer kind says."""
    check_supported(cfg)
    dtype = _dtype(cfg)

    def layer_cache(i):
        if cfg.mixer_kind(i) == "mamba":
            return L.mamba_cache_init(cfg, batch, dtype, device)
        make = (L.mla_cache_init if cfg.attn_kind == "mla"
                else L.gqa_cache_init)
        return make(cfg, batch, max_seq, dtype, device)
    return [layer_cache(i) for i in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params: LM, tokens, cache: Cache, *,
            patches=None):
    """Fill the cache with the prompt (GQA and MLA layers in place, Mamba
    layers' entries replaced in the list); ``patches`` as in
    :func:`forward`.  Returns (logits of the last position (B,1,V), or
    (B,1,CB,V), cache)."""
    x = embed_tokens(cfg, params, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run(cfg, params, x, positions, cache)
    return lm_head(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: LM, token, cache: Cache,
                pos: int):
    """One decode step. token: (B,1) int, or (B,1,CB); ``pos`` a Python
    int.  Writes the new k/v (GQA) or compressed row (MLA) at ``pos`` in
    place, or replaces the layer's state (Mamba); returns (logits (B,1,V)
    or (B,1,CB,V), cache)."""
    x = embed_tokens(cfg, params, token)
    positions = torch.full((1,), pos, device=x.device)
    x, _ = _run(cfg, params, x, positions, cache, pos)
    return lm_head(cfg, params, x), cache
