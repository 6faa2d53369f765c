"""Carry the JAX package's model parameters over to the port.

The JAX package stacks every layer's parameters over a leading
``n_blocks`` axis under ``params["blocks"]["sub<i>"]`` (one ``sub`` per
layer of the repeating period), keeps its leading dense layers
(deepseek's first) unstacked in the list ``params["pre_blocks"]``, and
keeps the attention weights as ``wq``/``wk``/``wv`` (d, heads, hd) and
``wo`` (heads, hd, d), MLA's as ``wq`` (d, H, nope+rope), ``wkv_b`` (R,
H, nope+v) and ``wo`` (H, v, d).  The port keeps one module per layer,
the pre-blocks first, with those weights flattened to the matmul layout
of ``models/layers.py`` (``wq`` (d, H*hd), ``wo`` (H*hd, d)).  MLA's
``wkv_a`` and ``kv_norm``, the MoE layer's arrays (``router``, the
stacked experts, the ``shared`` MLP) and a Mamba layer's already have the
port's layouts and are carried over as they are; a layer has ``ln2`` and
an ``mlp`` where the JAX layer has them (jamba's Mamba layers do,
falcon-mamba's do not).  The ``encodec_stub`` frontend's (CB, V, d)
embedding and (d, V*CB) head come across as they are.  This module is
the only place that knows both layouts.  Any tree of the
parameters' structure maps the same way: a JAX gradient tree or an AdamW
moment tree becomes a dict keyed by the port's parameter names
(:func:`named_from_jax`), and a whole JAX ``TrainState`` becomes the
port's (:func:`state_from_jax`).  Given a rank of a sharded model
(``res``), :func:`params_from_jax` returns that rank's block of the
parameters (``transformer.shard_params``), and :func:`whole_from_ranks`
makes every rank's blocks of a parameter tree (parameters, gradients,
moments) whole again.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.launch.mesh import coords as mesh_coords
from repro_torch.optim.adamw import TrainState
from repro_torch.parallel.sharding import Mesh, ShardingResolver, local_slice


def _tensor(a, device) -> nn.Parameter:
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # numpy's ml_dtypes extension type
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return nn.Parameter(t.to(device), requires_grad=False)


def params_from_jax(cfg: ModelConfig, params_np: Mapping[str, Any],
                    device="cuda", res=None) -> T.LM:
    """``params_np``: the JAX parameter tree of ``transformer.init_params``
    as nested dicts of numpy arrays -> the port's :class:`LM` on
    ``device``, in the arrays' dtype; with ``res`` (a rank of a sharded
    model) that rank's local :class:`LM`."""
    T.check_supported(cfg)
    P = cfg.block_period
    blocks = params_np["blocks"]
    n_blocks = np.asarray(blocks["sub0"]["ln1"]).shape[0]
    pre = list(params_np.get("pre_blocks", []))
    if len(pre) + n_blocks * P != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(pre)} leading layers and "
                         f"{n_blocks} blocks of {P} layers, config has "
                         f"{cfg.n_layers}")

    def t(a):
        return _tensor(a, device)

    def flat(a, lead):       # (lead, ..., last) -> (lead, -1) or (-1, last)
        a = np.asarray(a)
        return t(a.reshape(a.shape[0], -1) if lead else
                 a.reshape(-1, a.shape[-1]))

    def layer(lp):
        """One layer's JAX arrays (a block already sliced) -> Layer: its
        mixer by its own arrays (a Mamba block has ``in_proj``), an MLP
        and ``ln2`` only where the JAX layer has them."""
        mx = lp["mixer"]
        if "in_proj" in mx:
            mixer = L.Mamba(*(t(mx[n]) for n in L.Mamba.NAMES))
        elif cfg.attn_kind == "mla":
            mixer = L.MLA(flat(mx["wq"], True), t(mx["wkv_a"]),
                          t(mx["kv_norm"]), flat(mx["wkv_b"], True),
                          flat(mx["wo"], False))
        else:
            norms = ((t(mx["q_norm"]), t(mx["k_norm"]))
                     if cfg.qk_norm else (None, None))
            mixer = L.GQA(flat(mx["wq"], True), flat(mx["wk"], True),
                          flat(mx["wv"], True), flat(mx["wo"], False),
                          *norms)
        if "mlp" not in lp:
            return T.Layer(t(lp["ln1"]), None, mixer, None)
        mlp = lp["mlp"]
        dense = ("w_gate", "w_up", "w_down")
        if "router" in mlp:
            shared = (L.MLP(*(t(mlp["shared"][n]) for n in dense))
                      if "shared" in mlp else None)
            mlp = L.MoE(*(t(mlp[n]) for n in L.MoE.NAMES), shared)
        else:
            mlp = L.MLP(*(t(mlp[n]) for n in dense))
        return T.Layer(t(lp["ln1"]), t(lp["ln2"]), mixer, mlp)

    def sliced(tree, b):
        if isinstance(tree, Mapping):
            return {k: sliced(v, b) for k, v in tree.items()}
        return np.asarray(tree)[b]

    layers = [layer(lp) for lp in pre]
    for b in range(n_blocks):
        for i in range(P):
            layers.append(layer(sliced(blocks[f"sub{i}"], b)))
    head = (None if cfg.tie_embeddings
            else _tensor(params_np["lm_head"], device))
    lm = T.LM(_tensor(params_np["embed"], device), layers,
              _tensor(params_np["final_norm"], device), head)
    return lm if res is None else T.shard_params(cfg, lm, res)


def named_from_jax(cfg: ModelConfig, tree_np: Mapping[str, Any],
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A tree of the parameters' structure (gradients, moments) -> a dict
    from the port's parameter names (``named_parameters()``) to tensors
    on ``device``."""
    return {n: p.detach() for n, p in
            params_from_jax(cfg, tree_np, device).named_parameters()}


def state_from_jax(cfg: ModelConfig, state_np, device="cuda") -> TrainState:
    """A JAX ``TrainState`` (step, params, mu, nu as numpy arrays) -> the
    port's :class:`TrainState` on ``device``, its parameters trainable."""
    params = params_from_jax(cfg, state_np.params, device)
    params.requires_grad_(True)
    return TrainState(
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                          device=device),
        params=params, mu=named_from_jax(cfg, state_np.mu, device),
        nu=named_from_jax(cfg, state_np.nu, device))


def _place(cfg: ModelConfig, resolver: ShardingResolver, coords, owner,
           leaf: str, axes, whole: torch.Tensor, block: torch.Tensor):
    """Write the block of the rank at ``coords`` into ``whole``, as
    ``transformer.shard_params`` cut it (Mamba's fused ``in_proj`` half
    by half; a (heads, hd) pair kept flat split by its heads)."""
    if isinstance(owner, L.Mamba) and leaf == "in_proj":
        for w, b in zip(whole.chunk(2, dim=-1), block.chunk(2, dim=-1)):
            _place(cfg, resolver, coords, owner, "", axes, w, b)
        return
    shape = T.logical_shape(cfg, axes, whole.shape)
    sl = local_slice(resolver.mesh, resolver.spec(axes, shape, param=True),
                     shape, coords)
    view = whole if len(shape) == whole.dim() else whole.view(shape)
    view[sl] = block.reshape(view[sl].shape)


def whole_from_ranks(cfg: ModelConfig, mesh: Mesh, blocks, *,
                     resolver: Optional[ShardingResolver] = None) -> Dict[
        str, torch.Tensor]:
    """``blocks``: rank by rank (row-major on ``mesh``), a dict from
    parameter name to that rank's block of a parameter, a gradient or a
    moment (``transformer.shard_params``'s names and layouts, cut by
    ``resolver``: the ranks' own, FSDP for training; the tensor-parallel
    one of ``mesh`` when None) -> a dict from name to the whole tensor,
    as one process holds it, on the blocks' device.  A tensor whole on
    every rank is rank 0's."""
    abstract = T.init_abstract(cfg)
    axes = T.param_axes(cfg, abstract)
    resolver = resolver or ShardingResolver(mesh)
    out = {}
    for name, p in abstract.named_parameters():
        first = blocks[0][name]
        if first.shape == p.shape:
            out[name] = first.clone()
            continue
        owner, _, leaf = name.rpartition(".")
        whole = torch.empty(p.shape, dtype=first.dtype, device=first.device)
        for r, b in enumerate(blocks):
            _place(cfg, resolver, mesh_coords(mesh, r),
                   abstract.get_submodule(owner), leaf, axes[name], whole,
                   b[name])
        out[name] = whole
    return out
