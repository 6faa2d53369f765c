"""Train / serve step factories, the JAX package's ``training/step.py``.

``make_train_step`` builds the (state, batch) -> (state, metrics) step:
next-token cross-entropy from float32 logits, gradients by
``torch.autograd.grad`` (never ``.backward()``: nothing accumulates into
``.grad``, so threads that share the parameters may each take
gradients), accumulation over microbatches in float32, optional int8
error-feedback gradient compression, and AdamW in place.

Each factory takes ``res``, a rank of a model split over the
("data", "model") mesh (``parallel/collectives.py``), where the JAX
package takes its resolver.  A sharded train step computes on every rank
the same loss, takes the gradients of the rank's blocks (the collectives
carry them back), and hands them to AdamW with ``res``: the norm is the
whole model's and compression's scales are the whole tensors'.

The gradient convention under a "data" axis above 1: every rank's loss
is the whole batch's (the loss's sum and its mask's count are summed
over "data", so the loss, the aux and the metrics are equal on every
rank), and each collective's backward gives a rank the gradient of its
own part.  So the gradient of a block that FSDP splits over "data"
comes back reduce-scattered by the gather's backward, and that of a
weight "data" leaves whole is the rank's part, summed over "data" after
the backward (``ShardedRun.sum_over_data``, one all-reduce).  The train
step takes the whole batch on every rank: microbatch a is rows [a B/A,
(a+1) B/A), as in the JAX package, and a rank runs its "data" block of
them (``ShardedRun.rows``); the loss and gradient functions take the
rank's rows.

``make_prefill_step`` / ``make_decode_step`` wrap the cached model paths
for serving, on one card or as one rank of a sharded model.  The port
runs eagerly: nothing here is traced or compiled.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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
        if res is not None and res.data_size > 1:
            # the whole batch's sum and count, from every rank's rows
            num, den = res.data_sum(torch.stack([(nll * mask).sum(),
                                                 mask.sum()]))
            loss = num / torch.clamp(den, min=1.0)
        else:
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}
    return loss_fn


def _data_summed(cfg: ModelConfig, res) -> Optional[Callable]:
    """The function that sums, over "data", the gradients of the
    weights "data" leaves whole (a dict by name, the rest kept), or None
    where "data" is 1."""
    if res is None or res.data_size == 1:
        return None
    blocks = {n for n, ax in T.split_axes(cfg, res).items() if "data" in ax}

    def summed(grads):
        names = [n for n in grads if n not in blocks]
        return dict(grads, **dict(zip(names, res.sum_over_data(
            [grads[n] for n in names]))))
    return summed


def make_grad_fn(cfg: ModelConfig, res=None, *, data_sum: bool = True):
    """grad_fn(params, batch) -> ((total, metrics), grads), as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` returns them: the
    objective and the loss's metrics (detached), and a dict from parameter
    name to its gradient in the parameter's dtype, by
    ``torch.autograd.grad`` (with ``res``, of the rank's blocks, from the
    rank's rows of the batch: the whole model's gradients, the module's
    docstring; ``data_sum`` False leaves the whole weights' gradients
    the rank's parts, for the caller to sum over "data")."""
    loss_fn = make_loss_fn(cfg, res)
    summed = _data_summed(cfg, res) if data_sum else None

    def grad_fn(params, batch):
        names, leaves = zip(*params.named_parameters())
        total, metrics = loss_fn(params, batch)
        grads = dict(zip(names, torch.autograd.grad(total, leaves)))
        if summed is not None:
            grads = summed(grads)
        return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)
    return grad_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, *, res=None,
                    accum_steps: int = 1, compress: bool = False):
    """The (state, batch) -> (state, metrics) step (the module's
    docstring); ``ValueError`` where a microbatch does not split over a
    "data" axis above 1 (``transformer.check_batch``)."""
    grad_fn = make_grad_fn(cfg, res, data_sum=False)
    summed = _data_summed(cfg, res)
    split = {} if res is None else T.split_axes(cfg, res)

    def rows(mb):
        """The rank's rows of a microbatch (all of them where "data" is
        1)."""
        if summed is None:
            return mb
        sl = res.rows(next(iter(mb.values())).shape[0])
        return {k: v[sl] for k, v in mb.items()}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if summed is not None:
            T.check_batch(cfg, res.mesh,
                          next(iter(batch.values())).shape[0], accum_steps)
        if accum_steps == 1:
            (_, metrics), grads = grad_fn(state.params, rows(batch))
        else:
            A = accum_steps
            n = next(iter(batch.values())).shape[0] // A
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in state.params.named_parameters()}
            msum = {"loss": 0.0, "aux": 0.0}
            for a in range(A):
                mb = rows({k: v[a * n:(a + 1) * n]
                           for k, v in batch.items()})
                (_, m), g = grad_fn(state.params, mb)
                for name, x in g.items():
                    grads[name] += x
                msum = {k: msum[k] + m[k].float() for k in msum}
                del g
            grads = {name: g / A for name, g in grads.items()}
            metrics = {k: v / A for k, v in msum.items()}
        if summed is not None:
            grads = summed(grads)
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
