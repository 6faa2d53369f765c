"""AdamW with global-norm clipping and a cosine schedule, the JAX
package's ``optim/adamw.py`` with its arithmetic.

The state keeps the parameters as the model's ``nn.Module`` and the two
moments as dicts from parameter name (``named_parameters()``) to a tensor
of ``moment_dtype`` on that parameter's device.  All update math is in
float32, the bias corrections from the float32 step, and each new value
is cast back to its parameter's dtype.  Where the JAX package builds new
arrays, :func:`apply_updates` writes the parameters and moments in place
under ``torch.no_grad()``: a second copy of the weights is never made,
and the float32 update runs over slices of at most :func:`update_slice`
elements of each parameter.

On a rank of a sharded model (``res``) the parameters, gradients and
moments are the rank's blocks (over "model", and over "data" where FSDP
splits them, as ZeRO-3 keeps the moments); the norm that clips them is
the whole model's (each tensor's squares counted once: the blocks' sums
added over the ranks that hold distinct blocks of it, in one all-reduce
an axis), so every rank scales alike and the whole parameters stay
equal on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Dict, Mapping, NamedTuple, Sequence, Tuple,
                    Union)

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moments dtype: f32 is the default; bf16 halves the optimizer's memory
    moment_dtype: str = "float32"


# elements updated at a time: the update's float32 temporaries of one
# (E, d, f) expert array at full width would otherwise take tens of GB.
# On the host a slice's temporaries of hundreds of MB are fresh pages
# each time (the C allocator maps them anew), several times slower than
# slices of 2^20 elements, whose temporaries it reuses.  A card's caching
# allocator reuses them at any size, and there fewer slices launch fewer
# kernels
UPDATE_SLICE = 1 << 26
HOST_UPDATE_SLICE = 1 << 20


def update_slice(t: torch.Tensor) -> int:
    """The elements of ``t`` the update and the norm take at a time."""
    return HOST_UPDATE_SLICE if t.device.type == "cpu" else UPDATE_SLICE


class TrainState(NamedTuple):
    step: torch.Tensor              # () int32, on the parameters' device
    params: Any                     # the model's nn.Module
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def lr_at(opt: OptConfig, step) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_frac``; float32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(opt.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - opt.warmup_steps)
                    / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def init_state(params, opt: OptConfig) -> TrainState:
    """Zero moments for every parameter, step 0; makes the parameters
    trainable (``requires_grad_``)."""
    params.requires_grad_(True)
    mdt = getattr(torch, opt.moment_dtype)
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
        mu={n: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for n, p in named.items()},
        nu={n: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for n, p in named.items()})


def _reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of the JAX package's array for parameter ``name``: it
    stacks every layer's parameters over a leading ``n_blocks`` axis, so
    its ``ndim >= 2`` rule also decays each layer's norms and vectors
    (and never ``final_norm``).  The port keeps one module per layer and
    counts that axis back in."""
    return p.ndim + (1 if name.startswith("layers.") else 0)


def _square_sum(xs) -> torch.Tensor:
    """The float32 sum of the squares of every tensor's elements; a
    tensor above :func:`update_slice` elements a slice at a time."""
    sums = []
    for x in xs:
        flat, n = x.reshape(-1), update_slice(x)
        for i in range(0, max(flat.numel(), 1), n):
            sums.append(torch.sum(torch.square(flat[i:i + n].float())))
    return sum(sums)


def global_norm(tree: Mapping[str, torch.Tensor], res=None,
                split: Union[Sequence[str], Mapping[str, Sequence[str]]] = ()
                ) -> torch.Tensor:
    """The float32 norm of every tensor's elements together.  A tensor
    above :func:`update_slice` elements is squared and summed a slice at
    a time, as the update runs, so that its float32 temporaries stay
    small; a smaller one in one sum.  With ``res`` the tensors named in
    ``split`` are the rank's blocks, whose squares are summed over the
    ranks that hold the tensor's distinct blocks: ``split`` maps a name
    to the mesh axes that split it (``transformer.split_axes``; a list of
    names means the "model" axis), a block over "model" alone summed
    over the rank's "model" group, over "data" alone over its "data"
    group, over both over both; the rest are whole on every rank and
    counted once."""
    if res is None:
        return torch.sqrt(_square_sum(tree.values()))
    axes = (dict(split) if isinstance(split, Mapping)
            else {n: ("model",) for n in split})
    if res.data_size > 1:
        return torch.sqrt(_mesh_square_sum(tree, res, axes))
    blocks = [x for n, x in tree.items() if n in axes]
    whole = [x for n, x in tree.items() if n not in axes]
    total = (res.all_reduce(_square_sum(blocks)) if blocks
             else torch.zeros((), dtype=torch.float32,
                              device=next(iter(tree.values())).device))
    if whole:
        total = total + _square_sum(whole).to(total.device)
    return torch.sqrt(total)


def _mesh_square_sum(tree, res, axes) -> torch.Tensor:
    """The squares of ``tree`` on a mesh whose "data" axis exceeds 1, in
    two all-reduces: the blocks over "model" (alone, and the part of
    those over both) over the "model" group, then those over "data"
    (alone, and that part) over the "data" group."""
    parts = {(): [], ("model",): [], ("data",): [], ("data", "model"): []}
    for n, x in tree.items():
        parts[tuple(sorted(axes.get(n, ())))].append(x)
    dev = next(iter(tree.values())).device

    def sq(xs):
        return (_square_sum(xs).to(dev) if xs
                else torch.zeros((), dtype=torch.float32, device=dev))
    by_model = torch.stack([sq(parts[("model",)]),
                            sq(parts[("data", "model")])])
    if res.size > 1:
        by_model = res._reduce(by_model)
    by_data = res._reduce(torch.stack([sq(parts[("data",)]), by_model[1]]),
                          group=res.data_group)
    return sq(parts[()]) + by_model[0] + by_data[0] + by_data[1]


@torch.no_grad()
def apply_updates(state: TrainState, grads: Mapping[str, torch.Tensor],
                  opt: OptConfig, *, res=None,
                  split: Sequence[str] = ()) -> Tuple[TrainState, Dict]:
    """One AdamW step with ``grads`` (name -> gradient, any dtype, on each
    parameter's device).  Writes the parameters and moments in place and
    returns the state with the step advanced and ``{"grad_norm", "lr"}``
    (0-d float32 tensors).  ``res``, ``split``: a rank's blocks, as
    :func:`global_norm` takes them.  The moments are the rank's blocks
    too."""
    b1, b2 = opt.betas
    step = state.step + 1
    gnorm = global_norm(grads, res, split)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(opt, step)
    mdt = getattr(torch, opt.moment_dtype)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)
    for name, p in state.params.named_parameters():
        dev = p.device
        decay = _reference_ndim(name, p) >= 2  # decoupled, matrices only
        sc, lr_d, bc1_d, bc2_d = (x.to(dev) for x in (scale, lr, bc1, bc2))
        flat = [t.view(-1) for t in (p.data, state.mu[name],
                                     state.nu[name])]
        g_flat = grads[name].reshape(-1)
        # elementwise, so slices give the whole tensor's values: the
        # float32 temporaries stay at update_slice(p) elements each
        n = update_slice(p)
        for i in range(0, p.numel(), n):
            pf, mu, nu = (t[i:i + n] for t in flat)
            g = g_flat[i:i + n].float() * sc
            mu32 = mu.float() * b1 + (1 - b1) * g
            nu32 = nu.float() * b2 + (1 - b2) * g * g
            mu_hat = mu32 / bc1_d
            nu_hat = nu32 / bc2_d
            delta = mu_hat / (torch.sqrt(nu_hat) + opt.eps)
            if decay:
                delta = delta + opt.weight_decay * pf.float()
            pf.copy_((pf.float() - lr_d * delta).to(p.dtype))
            mu.copy_(mu32.to(mdt))
            nu.copy_(nu32.to(mdt))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return TrainState(step, state.params, state.mu, state.nu), metrics
