"""Rank bodies of ``tests/test_torch_sharded_train.py``: what each of the
four gloo ranks runs on the CPU.  The ranks are spawned processes that
import this module, so it imports ``repro_torch`` and never ``jax`` or
``repro`` (each rank returns the modules it loaded, which the test
reads)."""
import dataclasses
import sys

import numpy as np
import torch

from _sharded_rank import WORLD, unflatten

# batch rows and tokens a row (``tests/test_torch_train_families.py``'s)
B, L = 4, 32
# AdamW as the single-process training tests take it
OPT = dict(lr=1e-3, warmup_steps=1)
# (case id, arch, config changes, make_train_step's keywords, OptConfig
# changes); GQA configs at 8/4 heads as ``tests/_sharded_rank.py`` serves
# them, internvl2-1b at its published 14/2 (heads whole on every rank)
GQA = dict(n_heads=8, n_kv_heads=4)
CASES = [
    ("llama3.2-1b", "llama3.2-1b", GQA, {}, {}),
    ("qwen3-32b", "qwen3-32b", GQA, {}, {}),
    ("yi-9b", "yi-9b", GQA, {}, {}),
    ("stablelm-3b", "stablelm-3b", {}, {}, {}),
    ("dbrx-132b", "dbrx-132b", GQA, {}, {}),
    ("falcon-mamba-7b", "falcon-mamba-7b", {}, {}, {}),
    # two microbatches (the config's own override, which the planner reads)
    ("jamba-v0.1-52b", "jamba-v0.1-52b", dict(GQA, accum_override=2),
     dict(accum_steps=2), {}),
    ("musicgen-large", "musicgen-large", {}, {}, {}),
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", {}, {}, {}),
    ("internvl2-1b", "internvl2-1b", dict(n_heads=14, n_kv_heads=2), {},
     {}),
    ("falcon-mamba-7b-compress", "falcon-mamba-7b", {}, dict(compress=True),
     {}),
    # a clip norm far below the gradients' norm: every rank scales alike
    ("llama3.2-1b-clipped", "llama3.2-1b", GQA, {}, dict(clip_norm=0.05)),
]
# the cases whose counted collectives the planner's rank-0 step predicts
PLANNED = ["llama3.2-1b", "jamba-v0.1-52b", "dbrx-132b"]


def case_config(get, case):
    """The case's config from ``get`` (either package's ``get_smoke``)."""
    _, arch, changes, _, _ = case
    return dataclasses.replace(get(arch), **changes)


def train_cases(rank, world, case_dir):
    """Rank ``rank`` of every case: its blocks of the JAX package's
    parameters (``{case_dir}/{id}.npz``), their loss and gradients by
    ``make_grad_fn``, then one ``make_train_step`` (counted by ``OpCost``)
    from zero moments.  Returns by case id the loss, the gradients and
    the updated parameters (the rank's blocks, numpy), the step's metrics
    and collectives, and the names of the split parameters."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.parallel.collectives import sharded_run
    from repro_torch.training import step as S

    torch.set_num_threads(1)
    out = {}
    for case in CASES:
        cid, _, _, step_kw, opt_kw = case
        cfg = case_config(get_smoke, case)
        with np.load(f"{case_dir}/{cid}.npz") as data:
            flat = {k: data[k] for k in data.files}
        batch = {k[2:-2]: torch.from_numpy(flat.pop(k))
                 for k in [k for k in flat if k.startswith("__")]}
        res = sharded_run(cfg, make_test_mesh(world), rank=rank,
                          group=dist.group.WORLD, train=True)
        params = params_from_jax(cfg, unflatten(flat), device="cpu",
                                 res=res)
        params.requires_grad_(True)
        (total, m), grads = S.make_grad_fn(cfg, res)(params, batch)
        state = init_state(params, OptConfig(**OPT, **opt_kw))
        step = S.make_train_step(cfg, OptConfig(**OPT, **opt_kw), res=res,
                                 **step_kw)
        with op_cost.OpCost() as oc:
            state, metrics = step(state, batch)
        out[cid] = dict(
            total=float(total), loss=float(m["loss"]), aux=float(m["aux"]),
            grads={k: v.numpy() for k, v in grads.items()},
            params={k: v.detach().numpy()
                    for k, v in state.params.named_parameters()},
            metrics={k: float(v) for k, v in metrics.items()},
            collectives=oc.summary()["collectives"],
            split=T.split_names(cfg, res))
    out["modules"] = sorted(sys.modules)
    return out

