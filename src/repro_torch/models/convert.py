"""Carry the JAX package's model parameters over to the port.

The JAX package stacks every layer's parameters over a leading
``n_blocks`` axis under ``params["blocks"]["sub<i>"]`` (one ``sub`` per
layer of the repeating period) and keeps the attention weights as
``wq``/``wk``/``wv`` (d, heads, hd) and ``wo`` (heads, hd, d).  The port
keeps one module per layer with those weights flattened to the matmul
layout of ``models/layers.py`` (``wq`` (d, H*hd), ``wo`` (H*hd, d)).  A
Mamba layer's arrays already have the port's layouts (``x @ w``) and are
carried over as they are; its layer has no ``ln2`` and no ``mlp``.  This
module is the only place that knows both layouts.  Any tree of the
parameters' structure maps the same way: a JAX gradient tree or an AdamW
moment tree becomes a dict keyed by the port's parameter names
(:func:`named_from_jax`), and a whole JAX ``TrainState`` becomes the
port's (:func:`state_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import TrainState


def _tensor(a, device) -> nn.Parameter:
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # numpy's ml_dtypes extension type
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return nn.Parameter(t.to(device), requires_grad=False)


def params_from_jax(cfg: ModelConfig, params_np: Mapping[str, Any],
                    device="cuda") -> T.LM:
    """``params_np``: the JAX parameter tree of ``transformer.init_params``
    as nested dicts of numpy arrays -> the port's :class:`LM` on
    ``device``, in the arrays' dtype."""
    T.check_supported(cfg)
    P = cfg.block_period
    blocks = params_np["blocks"]
    n_blocks = np.asarray(blocks["sub0"]["ln1"]).shape[0]
    if n_blocks * P != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {n_blocks} blocks of {P} layers, "
                         f"config has {cfg.n_layers}")
    layers = []
    for b in range(n_blocks):
        for i in range(P):
            lp = blocks[f"sub{i}"]
            mx = lp["mixer"]
            if T._is_ssm(cfg):
                layers.append(T.Layer(
                    _tensor(lp["ln1"][b], device), None,
                    L.Mamba(*(_tensor(np.asarray(mx[n])[b], device)
                              for n in L.Mamba.NAMES)), None))
                continue
            mlp = lp["mlp"]
            wq, wk, wv, wo = (np.asarray(mx[n])[b]
                              for n in ("wq", "wk", "wv", "wo"))
            d = wq.shape[0]
            norms = ((_tensor(mx["q_norm"][b], device),
                      _tensor(mx["k_norm"][b], device))
                     if cfg.qk_norm else (None, None))
            mixer = L.GQA(_tensor(wq.reshape(d, -1), device),
                          _tensor(wk.reshape(d, -1), device),
                          _tensor(wv.reshape(d, -1), device),
                          _tensor(wo.reshape(-1, wo.shape[-1]), device),
                          *norms)
            layers.append(T.Layer(
                _tensor(lp["ln1"][b], device), _tensor(lp["ln2"][b], device),
                mixer, L.MLP(*(_tensor(mlp[n][b], device)
                               for n in ("w_gate", "w_up", "w_down")))))
    head = (None if cfg.tie_embeddings
            else _tensor(params_np["lm_head"], device))
    return T.LM(_tensor(params_np["embed"], device), layers,
                _tensor(params_np["final_norm"], device), head)


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
