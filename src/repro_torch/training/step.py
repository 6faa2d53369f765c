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

The gradient convention under a "data" or "pod" axis above 1: every
rank's loss is the whole batch's (the loss's sum and its mask's count
are summed over the ranks that hold distinct tokens,
``ShardedRun.token_sum``, so the loss, the aux and the metrics are equal
on every rank), and each collective's backward gives a rank the gradient
of its own part.  So the gradient of a block that FSDP splits over
"data" comes back reduce-scattered by the gather's backward, and that of
a weight split over no axis of the tokens is the rank's part, summed
over those ranks after the backward (``ShardedRun.sum_over_tokens``, one
all-reduce); rows replicated over an axis are counted once.  The train
step takes the whole batch on every rank: microbatch a is rows [a B/A,
(a+1) B/A), as in the JAX package, laid out as the resolver lays out its
tokens (``ShardedRun.for_batch``): a rank runs its block of the rows, or,
where the batch axes do not divide them, every row and its stretch of
the positions ("seq" over "data"), whose targets run one past the
stretch's end into the next (the global last position has none).  The
loss and gradient functions take the rank's rows (whole, under a
stretch), and ``res`` carrying the layout (a ``res`` without one: the
rows split over "data").

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
        S = tokens.shape[1]
        # the positions [a, a + m) of the logits (a stretch's, or all)
        # that have a next token
        a, n = (0, S) if res is None or res.stretch is None else res.stretch
        m = min(n, S - 1 - a)
        tgt = tokens[:, a + 1:a + 1 + m].long()   # (B,m), or (B,m,CB)
        lg = logits[:, :m]                  # (B,m,V), or (B,m,CB,V)
        logz = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
        nll = logz - ll
        mask = torch.ones(nll.shape[:2], dtype=torch.float32,
                          device=nll.device)
        if cfg.frontend == "vit_stub":
            # image-patch positions don't contribute to the LM loss
            pos = torch.arange(a, a + m, device=nll.device)
            mask = mask * (pos >= cfg.n_patches)[None, :]
        if nll.ndim == 3:
            nll = nll.mean(-1)
        if res is not None and res.token_group() is not None:
            # the whole batch's sum and count, from every rank's tokens
            num, den = res.token_sum(torch.stack([(nll * mask).sum(),
                                                  mask.sum()]))
            loss = num / torch.clamp(den, min=1.0)
        else:
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}
    return loss_fn


def _token_summed(cfg: ModelConfig, res) -> Optional[Callable]:
    """The function that sums the gradients (a dict by name) over the
    ranks that hold distinct tokens: those of the weights "data" leaves
    whole over all of them, those of the FSDP blocks (reduce-scattered
    over "data" already) over "pod" where the rows split over it too; or
    None where every rank holds the same tokens."""
    if res is None or res.token_group() is None:
        return None
    blocks = {n for n, ax in T.split_axes(cfg, res).items() if "data" in ax}
    pod = (res.pod_group if res.tokens is not None
           and "pod" in res.tokens.axes else None)

    def summed(grads):
        names = [n for n in grads if n not in blocks]
        out = dict(grads, **dict(zip(names, res.sum_over_tokens(
            [grads[n] for n in names]))))
        split = [n for n in grads if n in blocks]
        out.update(zip(split, res.sum_over([out[n] for n in split], pod)))
        return out
    return summed


def make_grad_fn(cfg: ModelConfig, res=None, *, token_sum: bool = True):
    """grad_fn(params, batch) -> ((total, metrics), grads), as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` returns them: the
    objective and the loss's metrics (detached), and a dict from parameter
    name to its gradient in the parameter's dtype, by
    ``torch.autograd.grad`` (with ``res``, of the rank's blocks, from the
    rank's rows of the batch: the whole model's gradients, the module's
    docstring; ``token_sum`` False leaves the whole weights' gradients
    the rank's parts, for the caller to sum over "data")."""
    loss_fn = make_loss_fn(cfg, res)
    summed = _token_summed(cfg, res) if token_sum else None

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
    docstring); ``ValueError`` where the batch does not lay out over the
    mesh (``transformer.check_batch``)."""
    split = {} if res is None else T.split_axes(cfg, res)
    made: Dict[Tuple[int, int], tuple] = {}

    def for_shape(n: int, S: int):
        """(the rank with the layout of microbatches of n rows of S
        positions, its grad_fn, its summing of the gradients)."""
        if (n, S) not in made:
            r = None if res is None else res.for_batch(n, S)
            made[n, S] = (r, make_grad_fn(cfg, r, token_sum=False),
                          _token_summed(cfg, r))
        return made[n, S]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        tokens = batch["tokens"]
        if res is not None:
            T.check_batch(cfg, tokens.shape[0], accum_steps)
        r, grad_fn, summed = for_shape(tokens.shape[0] // accum_steps,
                                       tokens.shape[1])

        def rows(mb):
            """The rank's rows of a microbatch."""
            return mb if r is None else {k: v[r.tokens.rows]
                                         for k, v in mb.items()}

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
        new_state, opt_metrics = adamw.apply_updates(
            state, grads, opt, res=res, split=split,
            unstacked=cfg.moe.first_dense)
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
