"""Train / serve step factories, the JAX package's ``training/step.py``.

``make_train_step`` builds the (state, batch) -> (state, metrics) step:
next-token cross-entropy from float32 logits, gradients by
``torch.autograd.grad`` (never ``.backward()``: nothing accumulates into
``.grad``, so threads that share the parameters may each take
gradients), accumulation over microbatches in float32, optional int8
error-feedback gradient compression, and AdamW in place.

Each factory takes ``res``, a rank of a model split over the mesh's
"model" axis (``parallel/collectives.py``), where the JAX package takes
its resolver.  A sharded train step computes on every rank the same loss
from the logits gathered whole, takes the gradients of the rank's blocks
(the collectives carry them back), and hands them to AdamW with ``res``:
the norm is the whole model's and compression's scales are the whole
tensors'.

``make_prefill_step`` / ``make_decode_step`` wrap the cached model paths
for serving, on one card or as one rank of a sharded model.  The port
runs eagerly: nothing here is traced or compiled.
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


def make_loss_fn(cfg: ModelConfig, res=None):
    """loss_fn(params, batch) -> (loss + AUX_WEIGHT * aux, {"loss",
    "aux"}), the JAX package's loss: the mean next-token NLL of
    ``batch["tokens"]`` (B,S), with the MoE layers' load-balancing aux.
    ``encodec_stub``: tokens (B,S,CB), each codebook of the next frame
    predicted, the NLL averaged over the codebooks; ``vit_stub``:
    ``batch["patches"]`` (B,n,d) take the first positions, which the mean
    leaves out (positions < ``cfg.n_patches``)."""

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits, aux = T.forward(cfg, params, tokens,
                                patches=batch.get("patches"), res=res)
        logits = logits.float()
        tgt = tokens[:, 1:].long()          # (B,S-1), or (B,S-1,CB)
        lg = logits[:, :-1]                 # (B,S-1,V), or (B,S-1,CB,V)
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
        nll = logz - ll
        mask = torch.ones(nll.shape[:2], dtype=torch.float32,
                          device=nll.device)
        if cfg.frontend == "vit_stub":
            # image-patch positions don't contribute to the LM loss
            pos = torch.arange(nll.shape[1], device=nll.device)
            mask = mask * (pos >= cfg.n_patches)[None, :]
        if nll.ndim == 3:
            nll = nll.mean(-1)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}
    return loss_fn


def make_grad_fn(cfg: ModelConfig, res=None):
    """grad_fn(params, batch) -> ((total, metrics), grads), as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` returns them: the
    objective and the loss's metrics (detached), and a dict from parameter
    name to its gradient in the parameter's dtype, by
    ``torch.autograd.grad`` (with ``res``, of the rank's blocks)."""
    loss_fn = make_loss_fn(cfg, res)

    def grad_fn(params, batch):
        names, leaves = zip(*params.named_parameters())
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves)
        return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
                dict(zip(names, grads)))
    return grad_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, *, res=None,
                    accum_steps: int = 1, compress: bool = False):
    grad_fn = make_grad_fn(cfg, res)
    split = () if res is None else T.split_names(cfg, res)

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
            grads, _ = C.compress_decompress(grads, None, res=res)
        new_state, opt_metrics = adamw.apply_updates(state, grads, opt,
                                                     res=res, split=split)
        metrics = dict(metrics, **opt_metrics)
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, res=None):
    """``res``: a rank of a sharded model (``parallel/collectives.py``),
    where the JAX package passes its resolver."""
    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return T.prefill(cfg, params, batch["tokens"], cache, res=res)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, res=None):
    @torch.inference_mode()
    def decode_step(params, token, cache, pos):
        return T.decode_step(cfg, params, token, cache, pos, res=res)
    return decode_step
