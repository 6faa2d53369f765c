"""Abstract input and state specs shared by the planner and the
launchers, the JAX package's ``launch/specs.py``.

Everything here lives on the ``meta`` device (``layers.ABSTRACT``): the
shapes and dtypes of a cell's inputs, parameters, AdamW state and caches,
with the logical axes the resolver consumes, and nothing allocated.
``input_specs`` gives the JAX package's int32 tokens; the port's
embedding reads them as they come.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig, TrainState
from repro_torch.parallel.sharding import ShardingResolver, Spec, shard_shape

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _sds((B, S) + cb, torch.int32)}
        if cfg.frontend == "vit_stub":
            out["patches"] = _sds((B, cfg.n_patches, cfg.d_model),
                                  torch.float32)
        return out
    if shape.kind == "decode":
        return {"token": _sds((B, 1) + cb, torch.int32),
                "pos": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def batch_logical_axes(cfg: ModelConfig,
                       shape: ShapeConfig) -> Dict[str, Tuple]:
    n = 3 if cfg.frontend == "encodec_stub" else 2
    if shape.kind in ("train", "prefill"):
        ax = {"tokens": ("batch", "seq", None)[:n]}
        if cfg.frontend == "vit_stub":
            ax["patches"] = ("batch", None, None)
        return ax
    return {"token": ("batch", None, None)[:n], "pos": ()}


def abstract_params(cfg: ModelConfig):
    """(the parameters on ``meta``, their logical axes by name)."""
    params = T.init_abstract(cfg)
    return params, T.param_axes(cfg, params)


def abstract_params_unstacked(cfg: ModelConfig):
    """:func:`abstract_params`.  The JAX package unstacks its per-block
    weights for the unrolled decode path, so that no whole-stack buffer
    exists on the device; the port keeps one module a layer and never
    stacks them, so its parameters are already unstacked."""
    return abstract_params(cfg)


def abstract_train_state(cfg: ModelConfig, opt: OptConfig):
    """(a :class:`TrainState` on ``meta``: the parameters, AdamW moments
    in ``opt.moment_dtype`` and the int32 step; its logical axes as a
    ``TrainState`` of dicts, ``()`` for the step)."""
    params, axes = abstract_params(cfg)
    state = adamw.init_state(params, opt)
    return state, TrainState(step=(), params=axes, mu=axes, nu=axes)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """(``init_cache`` on ``meta``, its logical axes)."""
    cache = T.init_cache(cfg, batch, max_seq, device=META)
    return cache, T.cache_axes(cfg, cache)


def named_tensors(tree, axes, prefix: str = ""):
    """[(name, tensor, logical axes)] of a state part: a module (with
    its axes by parameter name), a dict of tensors, a cache list, or one
    tensor with its axes tuple."""
    if hasattr(tree, "_asdict"):                  # TrainState
        return named_tensors(tree._asdict(), axes._asdict(), prefix)
    if isinstance(tree, torch.nn.Module):
        return [(prefix + n, t, axes[n]) for n, t in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("."), tree, axes)]
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += named_tensors(v, axes[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += named_tensors(v, axes[i], f"{prefix}{i}.")
        return out
    raise TypeError(f"{prefix}: {type(tree)}")


def state_shardings(resolver: ShardingResolver, cfg: ModelConfig,
                    tree, axes, *, param: bool = True
                    ) -> Dict[str, Tuple[Spec, Tuple[int, ...]]]:
    """The resolver over a (possibly nested) abstract state: each
    tensor's name -> (its spec, the logical shape the spec is of)."""
    out = {}
    for name, t, ax in named_tensors(tree, axes):
        shape = T.logical_shape(cfg, ax, t.shape)
        out[name] = (resolver.spec(ax, shape, param=param), shape)
    return out


def per_device_bytes(resolver: ShardingResolver, cfg: ModelConfig, tree,
                     axes, *, param: bool = True) -> int:
    """Bytes of one device's shards of ``tree`` (every tensor's
    ``shard_shape`` elements times its element size)."""
    specs = state_shardings(resolver, cfg, tree, axes, param=param)
    return sum(math.prod(shard_shape(resolver.mesh, *specs[name]))
               * t.element_size() for name, t, _ in named_tensors(tree, axes))
