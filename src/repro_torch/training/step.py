"""Train / serve step factories, the JAX package's ``training/step.py``.

``make_train_step`` builds the (state, batch) -> (state, metrics) step:
next-token cross-entropy from float32 logits, gradients by
``torch.autograd.grad`` (never ``.backward()``: nothing accumulates into
``.grad``, so threads that share the parameters may each take
gradients), accumulation over microbatches in float32, optional int8
error-feedback gradient compression, and AdamW in place.

``make_prefill_step`` / ``make_decode_step`` wrap the cached model paths
for serving.  The port runs eagerly: nothing here is traced or compiled.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import compress as C
from repro_torch.optim.adamw import OptConfig, TrainState

AUX_WEIGHT = 0.01


def make_loss_fn(cfg: ModelConfig):
    """loss_fn(params, batch) -> (loss + AUX_WEIGHT * aux, {"loss",
    "aux"}): the mean next-token NLL of ``batch["tokens"]`` (B,S)."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} loss is not ported to PyTorch "
            f"yet (ROADMAP.md Queue A item 5)")
    if cfg.moe.n_routed or cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"{cfg.name}: training MoE and MLA models is not ported to "
            f"PyTorch yet: the port serves them (ROADMAP.md Queue A item "
            f"10: the aux loss in the step, flash_attention_bwd at head "
            f"dim 192)")

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits, aux = T.forward(cfg, params, tokens)
        logits = logits.float()
        tgt = tokens[:, 1:].long()
        lg = logits[:, :-1]
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
        nll = logz - ll                              # (B,S-1)
        mask = torch.ones_like(nll)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}
    return loss_fn


def make_grad_fn(cfg: ModelConfig):
    """grad_fn(params, batch) -> ((total, metrics), grads), as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` returns them: the
    objective and the loss's metrics (detached), and a dict from parameter
    name to its gradient in the parameter's dtype, by
    ``torch.autograd.grad``."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        names, leaves = zip(*params.named_parameters())
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves)
        return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
                dict(zip(names, grads)))
    return grad_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, *,
                    accum_steps: int = 1, compress: bool = False):
    grad_fn = make_grad_fn(cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if accum_steps == 1:
            (_, metrics), grads = grad_fn(state.params, batch)
        else:
            A = accum_steps
            n = next(iter(batch.values())).shape[0] // A
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in state.params.named_parameters()}
            msum = {"loss": 0.0, "aux": 0.0}
            for a in range(A):
                mb = {k: v[a * n:(a + 1) * n] for k, v in batch.items()}
                (_, m), g = grad_fn(state.params, mb)
                for name, x in g.items():
                    grads[name] += x
                msum = {k: msum[k] + m[k].float() for k in msum}
                del g
            grads = {name: g / A for name, g in grads.items()}
            metrics = {k: v / A for k, v in msum.items()}
        if compress:
            grads, _ = C.compress_decompress(grads, None)
        new_state, opt_metrics = adamw.apply_updates(state, grads, opt)
        metrics = dict(metrics, **opt_metrics)
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return T.prefill(cfg, params, batch["tokens"], cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(params, token, cache, pos):
        return T.decode_step(cfg, params, token, cache, pos)
    return decode_step
