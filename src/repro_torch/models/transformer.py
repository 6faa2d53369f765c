"""Decoder LM of every family the JAX package covers: dense GQA
(llama3.2-1b, qwen3-32b, yi-9b, stablelm-3b), MoE with GQA or MLA
attention (dbrx-132b, deepseek-v2-lite-16b), pure Mamba1
(falcon-mamba-7b), the hybrid attention/Mamba period with MoE
(jamba-v0.1-52b) and the two modality frontends (internvl2-1b's
``vit_stub``, musicgen-large's ``encodec_stub``): ``embed -> layers ->
norm -> head``.  A PyTorch port of the JAX package's
``models/transformer.py``.

The JAX package stacks its layers' parameters over ``n_blocks`` and runs
them with ``lax.scan``; the port keeps one ``nn.Module`` per layer and
runs them in a plain Python loop.  The training forward rematerialises
as the JAX package's does, in two levels: the blocks (runs of
``cfg.block_period`` layers after the ``first_dense`` pre-blocks) fall
into G groups (``cfg.remat_groups``, else :func:`_auto_groups`), each
group under one ``torch.utils.checkpoint``, so that only the groups'
inputs are kept; with ``cfg.remat_inner`` "full" each layer inside a
group is checkpointed as well (a layer's forward then runs up to three
times a step), with "none" it is not.  With one group (or G not dividing
the blocks) each layer runs under its own checkpoint ("full") or none
("none"); a pre-block, which the JAX package leaves unchecked, runs
under its own checkpoint whenever the forward rematerialises.  Layer i's
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

Sharded runs (``res``, a ``parallel.collectives.ShardedRun``): each
rank holds its block of every weight (:func:`shard_params`) and of every
cache entry (:func:`init_cache`), split over the ("data", "model") mesh
as the JAX package's resolver splits them, and the layers join the
partial results with the run's collectives.  Where "data" exceeds 1 a
rank takes its rows of the batch (``res.rows``): :func:`forward`,
:func:`prefill` and :func:`decode_step` take the rank's rows and its
cache holds them; under the FSDP resolver a weight's block is split over
"data" too, and is gathered whole before use (:func:`_gathered` at the
start of each layer, the embedding, the final norm and the head where
they are used), so that no layer sees a block split over "data".  Where
the resolver splits a cache by positions ("kv_seq"), a rank's entry is a
stretch of them: :func:`init_cache` gives a :class:`RankCache` that knows
the whole length, and :func:`prefill` and :func:`decode_step` hand it to the
layers, which ask ``res.kv_stretch`` for the rank's stretch.  The
embedding is a lookup of the rank's vocab rows and one all-reduce; the
head gathers the logits over the vocab, so every rank holds them whole.
Training
(:func:`forward` with ``res``) runs the same collectives, which carry
the gradients back (``ShardedRun.enter`` where an equal tensor meets a
block); under remat the recompute runs a segment's collectives again, in
the same order on every rank.  With ``res`` None every function runs as it does on
one card.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (DATA, MODEL, Mesh, local_slice,
                                           shard_shape)

Cache = List[Dict[str, torch.Tensor]]
Logical = Tuple[Optional[str], ...]


class RankCache(list):
    """A rank's cache (:func:`init_cache` with ``res``): the blocks of its
    layers' entries, and ``max_seq``, the whole cache's length, from
    which the layers ask the resolver whether the positions are split."""

    def __init__(self, layers, max_seq: int):
        super().__init__(layers)
        self.max_seq = max_seq


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
# sharding over the mesh's "model" axis
# ---------------------------------------------------------------------------

def _check_mesh(cfg: ModelConfig, mesh: Mesh, what: str) -> int:
    """The size of ``mesh``'s "model" axis; ``ValueError`` unless the
    mesh is ("data", "model"): a "pod" axis above 1 (the JAX package's
    multi-pod mesh) is not ported."""
    check_supported(cfg)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if MODEL not in sizes or any(n > 1 for a, n in sizes.items()
                                 if a not in (MODEL, DATA)):
        raise ValueError(f"{cfg.name}: sharded {what} splits the "
                         f"'{DATA}' and '{MODEL}' axes only, not mesh "
                         f"{mesh.axis_names} x {mesh.shape} (a 'pod' axis "
                         f"above 1 is not ported)")
    return sizes[MODEL]


def check_batch(cfg: ModelConfig, mesh: Mesh, batch: int,
                accum: int = 1) -> None:
    """``ValueError`` unless every microbatch of a training ``batch`` of
    ``accum`` microbatches splits over the mesh's "data" axis: where it
    does not, the JAX resolver puts the activations' "seq" on "data"
    instead, which the port does not run (a rank would hold replicated
    rows, and summed gradients would count them twice)."""
    n = dict(zip(mesh.axis_names, mesh.shape)).get(DATA, 1)
    if n > 1 and (batch % accum or (batch // accum) % n):
        raise ValueError(f"{cfg.name}: a training batch of {batch} rows in "
                         f"{accum} microbatches does not split over "
                         f"'{DATA}' = {n} (the JAX resolver's 'seq' over "
                         f"'{DATA}' fallback is not ported)")


def _check_heads(cfg: ModelConfig, n: int) -> None:
    """GQA's kv heads must split wherever its query heads do: a rank's
    query heads would otherwise need kv heads of the others' groups."""
    if (cfg.attn_kind == "gqa" and cfg.n_heads % n == 0
            and cfg.n_kv_heads % n):
        raise ValueError(f"{cfg.name}: {cfg.n_heads} query heads split "
                         f"over {n} ranks and {cfg.n_kv_heads} kv heads "
                         f"do not")


def check_trainable(cfg: ModelConfig, mesh: Mesh,
                    batch: Optional[int] = None, accum: int = 1) -> None:
    """Raise ``ValueError`` unless ranks can train ``cfg`` split over
    ``mesh``'s "data" and "model" axes: no other axis may exceed 1, the
    heads split as :func:`_check_heads` asks and, given ``batch``, each
    of its ``accum`` microbatches splits over "data"
    (:func:`check_batch`)."""
    _check_heads(cfg, _check_mesh(cfg, mesh, "training"))
    if batch is not None:
        check_batch(cfg, mesh, batch, accum)


def check_shardable(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise ``ValueError`` unless ranks can serve ``cfg`` split over
    ``mesh``'s "data" and "model" axes: no other axis may exceed 1, and
    the heads split as :func:`_check_heads` asks.  A cache that the
    resolver splits by positions ("kv_seq": every MLA cache, and GQA's
    when the kv heads do not divide over the axis) is served: each rank
    holds a stretch of positions and a decode step combines the ranks'
    partials.  A batch that "data" does not divide is served replicated
    over "data": every "data" rank computes every row."""
    _check_heads(cfg, _check_mesh(cfg, mesh, "serving"))


def _data_dim(res, spec, flat_at: Optional[int]) -> Optional[int]:
    """The port's dim of a parameter that ``spec`` splits over a "data"
    axis above 1, else None; ``flat_at``: the dim where the port keeps a
    (heads, hd) pair flat (the spec's dims after it move down one)."""
    if res.data_size == 1:
        return None
    for i, ax in enumerate(spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        if DATA in axes:
            return i - 1 if flat_at is not None and i > flat_at else i
    return None


def _local(res, cfg: ModelConfig, owner: nn.Module, leaf: str, axes,
           t: torch.Tensor) -> nn.Parameter:
    """The rank's block of parameter ``t`` (a copy: the whole tensor can
    be freed).  Mamba's fused ``in_proj`` (d, 2 di) is split half by
    half, the rank's block of the x columns beside the same block of the
    z columns.  A block that the resolver splits over "data" (FSDP)
    carries ``fsdp``: (its dim, whether it is such a pair of halves),
    which :func:`_gathered` reads."""
    if isinstance(owner, L.Mamba) and leaf == "in_proj":
        halves = [_local(res, cfg, owner, "", axes, h)
                  for h in t.chunk(2, dim=-1)]
        p = L._frozen(torch.cat(halves, dim=-1))
        if hasattr(halves[0], "fsdp"):
            dim = halves[0].fsdp[0]
            p.fsdp = (dim, dim == t.dim() - 1)
        return p
    shape = logical_shape(cfg, axes, t.shape)
    spec = res.resolver.spec(axes, shape, param=True)
    block = t.reshape(shape)[local_slice(res.mesh, spec, shape,
                                         res.coords)]
    flat_at = None
    if len(shape) > t.dim():   # a (heads, hd) pair the port keeps flat
        flat_at = next(k for k in range(t.dim()) if t.shape[k] != shape[k])
        block = block.flatten(flat_at, flat_at + 1)
    p = L._frozen(block.clone())
    dim = _data_dim(res, spec, flat_at)
    if dim is not None:
        p.fsdp = (dim, False)
    return p


def shard_params(cfg: ModelConfig, params: LM, res) -> LM:
    """The rank's local :class:`LM`: every parameter's block under the
    resolver's spec (``param_axes``, ``logical_shape``), modules and
    names as in ``params``; a tied embedding is split once, over the
    vocab.  ``params`` is left as it is."""
    axes = param_axes(cfg, params)

    def local(module: nn.Module, prefix: str) -> nn.Module:
        new = copy.copy(module)
        new._parameters = {
            k: None if p is None else _local(res, cfg, module, k,
                                             axes[prefix + k], p)
            for k, p in module._parameters.items()}
        new._modules = {k: None if m is None else local(m, f"{prefix}{k}.")
                        for k, m in module._modules.items()}
        return new
    return local(params, "")


def split_axes(cfg: ModelConfig, res) -> Dict[str, Tuple[str, ...]]:
    """The parameters that :func:`shard_params` cuts into blocks for
    ``res``'s rank (the resolver splits a dim of theirs over a mesh axis
    above 1), by name in ``named_parameters()`` order, each with the
    mesh axes that split it (sorted); the others are whole, and equal,
    on every rank.  Read from the shapes alone, so that a step counted
    by ``launch/op_cost.py`` may call it before the mode starts."""
    sizes = dict(zip(res.mesh.axis_names, res.mesh.shape))
    whole = init_abstract(cfg)
    axes = param_axes(cfg, whole)
    out = {}
    for n, p in whole.named_parameters():
        shape = logical_shape(cfg, axes[n], p.shape)
        used = sorted(a for s in res.resolver.spec(axes[n], shape,
                                                   param=True)
                      if s is not None
                      for a in ((s,) if isinstance(s, str) else s)
                      if sizes[a] > 1)
        if used:
            out[n] = tuple(used)
    return out


def split_names(cfg: ModelConfig, res) -> List[str]:
    """The names of :func:`split_axes`' parameters, in its order."""
    return list(split_axes(cfg, res))


def _whole(res, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """``params`` with every FSDP block (a ``fsdp`` tag of
    :func:`_local`) made whole over "data", all by one
    ``res.gather_blocks``, whose backward reduce-scatters their
    gradients to the blocks; the others as they are."""
    if res is None or res.data_size == 1:
        return list(params)
    blocks, dims = [], []
    for p in params:
        if hasattr(p, "fsdp"):
            dim, halves = p.fsdp
            parts = p.chunk(2, dim=-1) if halves else (p,)
            blocks.extend(parts)
            dims.extend([dim] * len(parts))
    if not blocks:
        return list(params)
    whole = iter(res.gather_blocks(blocks, dims))
    out = []
    for p in params:
        if not hasattr(p, "fsdp"):
            out.append(p)
        elif p.fsdp[1]:
            out.append(torch.cat([next(whole), next(whole)], dim=-1))
        else:
            out.append(next(whole))
    return out


def _gathered(module: nn.Module, res) -> nn.Module:
    """``module`` with its parameters made whole over "data"
    (:func:`_whole`): a shallow copy holding the gathered tensors, which
    live as long as it does; ``module`` itself where nothing of it is
    split over "data"."""
    params = list(module.parameters())
    if res is None or not any(hasattr(p, "fsdp") for p in params):
        return module
    new = {id(p): w for p, w in zip(params, _whole(res, params))}

    def swap(m: nn.Module) -> nn.Module:
        c = copy.copy(m)
        c._parameters = {k: None if p is None else new[id(p)]
                         for k, p in m._parameters.items()}
        c._modules = {k: None if x is None else swap(x)
                      for k, x in m._modules.items()}
        return c
    return swap(module)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _lookup(cfg: ModelConfig, table, ids, res=None):
    """``table[ids]``; with ``res`` and a block of the vocab's rows (fewer
    than ``cfg.vocab_size``), the rank's rows and zeros for the others."""
    if res is None or table.shape[0] == cfg.vocab_size:
        return table[ids]
    n = table.shape[0]
    local = ids - res.rank * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def embed_tokens(cfg: ModelConfig, params: LM, tokens, patches=None,
                 res=None):
    """tokens: (B,S) int, or (B,S,CB) with the ``encodec_stub`` frontend
    (the codebooks' embeddings summed in order); with the ``vit_stub``
    frontend, ``patches`` (B,n,d) take the first n positions' places.
    With ``res`` splitting the vocab each rank sums its rows (zeros for
    the others' tokens) and one all-reduce adds the ranks' sums."""
    tokens = tokens.long()
    embed, = _whole(res, [params.embed])
    if _codebooks(cfg):
        x = _lookup(cfg, embed[0], tokens[..., 0], res)
        for cb in range(1, cfg.n_codebooks):
            x = x + _lookup(cfg, embed[cb], tokens[..., cb], res)
    else:
        x = _lookup(cfg, embed, tokens, res)
    if res is not None and embed.shape[-2] < cfg.vocab_size:
        x = res.all_reduce(x)
    if cfg.frontend == "vit_stub" and patches is not None:
        n = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
    return x


def lm_head(cfg: ModelConfig, params: LM, x, res=None):
    """(..., d) -> logits (..., V), or (..., CB, V) with the
    ``encodec_stub`` frontend (a tied head reads the codebooks'
    embeddings as one (CB*V, d) table).  With ``res`` splitting the
    vocab the rank's logits are gathered over it: every rank returns them
    whole."""
    cb = _codebooks(cfg)
    w, = _whole(res, [params.embed if cfg.tie_embeddings
                      else params.lm_head])
    split = res is not None and (
        w.shape[-2] < cfg.vocab_size if cfg.tie_embeddings
        else w.shape[-1] < cfg.vocab_size * max(cb, 1))
    if split:
        x = res.enter(x)
    if cfg.tie_embeddings:
        logits = x @ w.reshape(-1, cfg.d_model).T
        if cb:
            logits = logits.unflatten(-1, (cb, -1))
    else:
        logits = x @ w
    if split:
        logits = res.all_gather(logits, -1)
    if cb and not cfg.tie_embeddings:
        logits = logits.unflatten(-1, (cb, cfg.vocab_size))
    return logits


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, lp: Layer, x, positions, cache=None,
                 pos=None, res=None, max_seq=None):
    """Returns (x, the layer's aux loss (float32; 0 but for an MoE
    layer), the layer's cache entry); decode when ``pos`` is given;
    ``max_seq`` a rank's whole cache length (:class:`RankCache`).  The
    layer's FSDP blocks are gathered first (:func:`_gathered`): no layer
    sees a block split over "data", and the gathered weights go with the
    layer's call (a remat recompute gathers them again)."""
    lp = _gathered(lp, res)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
    if isinstance(lp.mixer, L.Mamba):
        h, cache = L.mamba_apply(cfg, lp.mixer, h, cache=cache,
                                 decode=pos is not None, res=res)
    elif isinstance(lp.mixer, L.MLA):
        h, cache = L.mla_apply(cfg, lp.mixer, h, positions, cache=cache,
                               pos=pos, res=res, max_seq=max_seq)
    else:
        h, cache = L.gqa_apply(cfg, lp.mixer, h, positions, cache=cache,
                               pos=pos, res=res, max_seq=max_seq)
    x = x + h
    if lp.mlp is not None:
        h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
        if isinstance(lp.mlp, L.MoE):
            h, aux = L.moe_apply(cfg, lp.mlp, h, res=res)
        else:
            h = L.mlp_apply(cfg, lp.mlp, h, res=res)
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


def _auto_groups(n_blocks: int) -> int:
    """The largest divisor of ``n_blocks`` that is at most its square
    root: the JAX package's number of remat groups when the config sets
    none."""
    g, d = 1, 1
    while d * d <= n_blocks:
        if n_blocks % d == 0:
            g = d
        d += 1
    return g


def remat_segments(cfg: ModelConfig,
                   n_layers: Optional[int] = None) -> Tuple[List[int],
                                                            List[List[int]]]:
    """How the training forward checkpoints ``n_layers`` layers (the
    config's by default): (the pre-blocks' indices, each under its own
    checkpoint; the groups, each a list of layer indices under one
    checkpoint).  No groups when G is 1 or does not divide the blocks:
    every layer is then a pre-block of its own, as the flat remat runs
    them."""
    n = cfg.n_layers if n_layers is None else n_layers
    pre = min(cfg.moe.first_dense, n)
    n_blocks = (n - pre) // cfg.block_period
    G = cfg.remat_groups or _auto_groups(n_blocks)
    if G <= 1 or n_blocks % G or (n - pre) % cfg.block_period:
        return list(range(n)), []
    seg = (n - pre) // G
    return list(range(pre)), [list(range(pre + g * seg, pre + (g + 1) * seg))
                              for g in range(G)]


def forward_runs(cfg: ModelConfig,
                 n_layers: Optional[int] = None) -> List[int]:
    """How many times one training step (:func:`forward` with remat, and
    its backward) runs each layer's forward: once, once more for its own
    checkpoint's recompute, and once more for its group's.  A group's
    recompute stops once it has rebuilt what the group keeps (the
    checkpoint's early stop), so with ``remat_inner`` "full" it leaves
    the group's last layer out; with "none" it runs every layer of the
    group, whose internals the group keeps."""
    n = cfg.n_layers if n_layers is None else n_layers
    if cfg.remat_policy == "everything":
        return [1] * n
    pre, groups = remat_segments(cfg, n)
    inner = cfg.remat_inner != "none"
    runs = [1] * n
    for i in pre:
        runs[i] = 2 if inner or groups else 1
    for group in groups:
        for i in group:
            runs[i] = 3 if inner and i != group[-1] else 2
    return runs


def _checkpoint(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant), as
    ``cfg.remat_policy`` says: "nothing" keeps only the inputs and
    recomputes the rest in the backward, "dots" also keeps the matmul
    outputs."""
    from torch.utils.checkpoint import checkpoint
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_dots)
    return checkpoint(fn, *args, use_reentrant=False)


def _run_layers(cfg: ModelConfig, layers, positions, inner: bool,
                res=None):
    """A function of (x, aux) that runs ``layers`` in turn, each under
    its own checkpoint when ``inner``, and adds their aux losses."""
    def body(lp):
        return lambda x: _apply_layer(cfg, lp, x, positions, res=res)[:2]

    def run(x, aux):
        for lp in layers:
            if inner:
                x, a = _checkpoint(cfg, body(lp), x)
            else:
                x, a, _ = _apply_layer(cfg, lp, x, positions, res=res)
            aux = aux + a
        return x, aux
    return run


def _run_remat(cfg: ModelConfig, params: LM, x, positions, res=None):
    """The training forward's layers and final norm, checkpointed as
    :func:`remat_segments` says (the module's docstring); returns (x, the
    summed aux loss).  The aux sum runs through the groups in layer
    order, so its value is that of the forward without remat."""
    pre, groups = remat_segments(cfg, len(params.layers))
    inner = cfg.remat_inner != "none"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # "none" without groups rematerialises nothing
    x, aux = _run_layers(cfg, [params.layers[i] for i in pre], positions,
                         inner or bool(groups), res)(x, aux)
    for group in groups:
        x, aux = _checkpoint(cfg, _run_layers(
            cfg, [params.layers[i] for i in group], positions, inner, res),
            x, aux)
    return L.rmsnorm(x, _whole(res, [params.final_norm])[0],
                     cfg.norm_eps), aux


def _max_seq(cache, res):
    """The whole length of a rank's cache (None without ``res``); raise
    unless a sharded run's cache is a :class:`RankCache`."""
    if res is None:
        return None
    if not isinstance(cache, RankCache):
        raise ValueError("a sharded run takes the rank's cache of "
                         "init_cache(..., res=...)")
    return cache.max_seq


def _run(cfg, params: LM, x, positions, cache=None, pos=None, res=None,
         max_seq=None):
    """The layers and the final norm; returns (x, the summed aux loss).
    ``max_seq``: a rank's whole cache length (:func:`_max_seq`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.layers):
        x, a, layer_cache = _apply_layer(
            cfg, lp, x, positions, None if cache is None else cache[i],
            pos, res, max_seq)
        if cache is not None:
            cache[i] = layer_cache
        aux = aux + a
    return L.rmsnorm(x, _whole(res, [params.final_norm])[0],
                     cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: LM, tokens, *, patches=None,
            remat: bool = True, res=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Training/scoring forward. tokens: (B,S) int (or (B,S,CB));
    ``patches`` (B,n,d) for the ``vit_stub`` frontend; ``res`` a rank of
    a sharded model (the module's docstring), whose logits come out whole.
    Returns (logits, aux_loss): the MoE layers' load-balancing losses
    summed (float32; 0.0 without MoE layers).

    With ``remat`` and grad enabled the layers are checkpointed in two
    levels as the JAX package's are (the module's docstring,
    :func:`remat_segments`) unless ``cfg.remat_policy`` is "everything".
    Checkpointing changes what the backward keeps, not the values."""
    x = embed_tokens(cfg, params, tokens, patches, res)
    positions = torch.arange(x.shape[1], device=x.device)
    if (remat and torch.is_grad_enabled()
            and cfg.remat_policy != "everything"):
        x, aux = _run_remat(cfg, params, x, positions, res)
    else:
        x, aux = _run(cfg, params, x, positions, res=res)
    return lm_head(cfg, params, x, res), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda", res=None) -> Cache:
    """One zeroed cache per layer, in ``cfg.dtype``: ``{"k", "v"}`` of
    (batch, max_seq, KH, hd) for a GQA layer; ``{"ckv", "krope"}`` of
    (batch, max_seq, kv_lora_rank) and (batch, max_seq, rope_head_dim)
    for an MLA layer; ``{"h", "conv"}`` for a Mamba layer
    (``mamba_cache_init``: its size does not depend on ``max_seq``),
    each layer's as its mixer kind says.  With ``res``, a
    :class:`RankCache` of the rank's block of each entry (the resolver's
    spec over ``cache_axes``: a stretch of ``max_seq`` // n positions
    where it splits "kv_seq" over the n ranks, the rank's rows of
    ``batch`` where it splits "batch" over "data")."""
    check_supported(cfg)
    dtype = _dtype(cfg)
    if res is not None:
        whole = init_cache(cfg, batch, max_seq, device="meta")
        return RankCache(
            [{k: torch.zeros(shard_shape(res.mesh, res.resolver.spec(
                ax[k], t.shape), t.shape), dtype=t.dtype, device=device)
              for k, t in c.items()}
             for c, ax in zip(whole, cache_axes(cfg, whole))], max_seq)

    def layer_cache(i):
        if cfg.mixer_kind(i) == "mamba":
            return L.mamba_cache_init(cfg, batch, dtype, device)
        make = (L.mla_cache_init if cfg.attn_kind == "mla"
                else L.gqa_cache_init)
        return make(cfg, batch, max_seq, dtype, device)
    return [layer_cache(i) for i in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params: LM, tokens, cache: Cache, *,
            patches=None, res=None):
    """Fill the cache with the prompt (GQA and MLA layers in place, Mamba
    layers' entries replaced in the list); ``patches`` as in
    :func:`forward`; ``res`` a rank of a sharded model (the module's
    docstring).  Returns (logits of the last position (B,1,V), or
    (B,1,CB,V), cache)."""
    max_seq = _max_seq(cache, res)
    x = embed_tokens(cfg, params, tokens, patches, res)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run(cfg, params, x, positions, cache, res=res, max_seq=max_seq)
    return lm_head(cfg, params, x[:, -1:], res), cache


def decode_step(cfg: ModelConfig, params: LM, token, cache: Cache,
                pos: int, *, res=None):
    """One decode step. token: (B,1) int, or (B,1,CB); ``pos`` a Python
    int.  Writes the new k/v (GQA) or compressed row (MLA) at ``pos`` in
    place, or replaces the layer's state (Mamba); returns (logits (B,1,V)
    or (B,1,CB,V), cache)."""
    max_seq = _max_seq(cache, res)
    x = embed_tokens(cfg, params, token, res=res)
    positions = torch.full((1,), pos, device=x.device)
    x, _ = _run(cfg, params, x, positions, cache, pos, res=res,
                max_seq=max_seq)
    return lm_head(cfg, params, x, res), cache
