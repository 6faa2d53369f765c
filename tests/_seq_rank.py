"""Rank bodies of ``tests/test_torch_sharded_seq.py`` and
``tests/test_torch_sharded_pod.py``: what each of the four gloo ranks
runs on the CPU, on the ("data", "model") = (2, 2) mesh with microbatches
that "data" does not divide (their positions split over "data") or with
the "global" MoE dispatch, and on the ("pod", "data", "model") = (2, 1,
2) mesh.  The ranks are spawned processes that import this module, so it
imports ``repro_torch`` and never ``jax`` or ``repro`` (each rank returns
the modules it loaded, which the tests read)."""
import dataclasses
import sys

import numpy as np
import torch

from _sharded_rank import unflatten

WORLD = 4
L = 32                       # tokens a row
OPT = dict(lr=1e-3, warmup_steps=1)
GQA = dict(n_heads=8, n_kv_heads=4)
SEQ_MESH = (("data", "model"), (2, 2))
POD_MESH = (("pod", "data", "model"), (2, 1, 2))
# (case id, arch, config changes, the "global" dispatch, batch rows,
# microbatches[, tokens a row: L unless given]): rows that "data" does not
# divide put each row's positions on "data" (stretches of 16);
# internvl2-1b at 14/2 heads with 20 patches, which run across the
# stretches' boundary; a row of 31 tokens, which "data" divides neither
# way, is every rank's (the FSDP gradients then taken, not summed)
SEQ_CASES = [
    ("llama3.2-1b", "llama3.2-1b", GQA, False, 1, 1),
    ("llama3.2-1b-accum", "llama3.2-1b", GQA, False, 2, 2),
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", {}, False, 1, 1),
    ("jamba-v0.1-52b", "jamba-v0.1-52b", GQA, False, 1, 1),
    ("falcon-mamba-7b", "falcon-mamba-7b", {}, False, 1, 1),
    ("internvl2-1b", "internvl2-1b", dict(n_heads=14, n_kv_heads=2,
                                          n_patches=20), False, 1, 1),
    # the "global" dispatch under a row split and under a position split
    ("deepseek-global-rows", "deepseek-v2-lite-16b", {}, True, 4, 1),
    ("deepseek-global-seq", "deepseek-v2-lite-16b", {}, True, 1, 1),
    ("jamba-global-rows", "jamba-v0.1-52b", GQA, True, 4, 1),
    ("jamba-global-seq", "jamba-v0.1-52b", GQA, True, 1, 1),
    ("llama3.2-1b-replicated", "llama3.2-1b", GQA, False, 1, 1, 31),
]
# on (2, 1, 2): a batch of 4 (rows over "pod") and of 1 (replicated over
# "pod")
POD_CASES = [
    ("llama3.2-1b-rows", "llama3.2-1b", GQA, False, 4, 1),
    ("llama3.2-1b-one", "llama3.2-1b", GQA, False, 1, 1),
    ("deepseek-v2-lite-16b-rows", "deepseek-v2-lite-16b", {}, False, 4, 1),
    ("deepseek-v2-lite-16b-one", "deepseek-v2-lite-16b", {}, False, 1, 1),
]
# the served pod case: a prompt of P, STEPS teacher-forced steps, B rows
SERVE_ARCH, SERVE_B, SERVE_P, SERVE_STEPS = "llama3.2-1b", 4, 32, 3


def case_length(case):
    """Tokens a row of the case's batch."""
    return case[6] if len(case) > 6 else L


def case_config(get, case):
    """The case's config from ``get`` (either package's ``get_smoke``)."""
    _, arch, changes, global_ = case[:4]
    cfg = dataclasses.replace(get(arch), **changes)
    if global_:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="global"))
    return cfg


def mesh(spec):
    from repro_torch.parallel.sharding import Mesh
    return Mesh(*spec)


def _load(case_dir, name):
    with np.load(f"{case_dir}/{name}.npz") as data:
        flat = {k: data[k] for k in data.files}
    extra = {k[2:-2]: flat.pop(k) for k in [k for k in flat
                                           if k.startswith("__")]}
    return unflatten(flat), extra


def _train(rank, case_dir, cases, spec):
    """Each case on this rank: its blocks (FSDP) of the JAX package's
    parameters, the loss and gradients of its part of the batch by
    ``make_grad_fn`` with the batch's layout (one microbatch), then one
    ``make_train_step`` of the whole batch (counted by ``OpCost``) from
    zero moments."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import op_cost
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.parallel.collectives import sharded_run
    from repro_torch.training import step as S

    out = {}
    for case in cases:
        cid, accum = case[0], case[5]
        cfg = case_config(get_smoke, case)
        tree, batch = _load(case_dir, f"train-{cid}")
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        res = sharded_run(cfg, mesh(spec), rank=rank,
                          group=dist.group.WORLD, train=True)
        params = params_from_jax(cfg, tree, device="cpu", res=res)
        params.requires_grad_(True)
        n = batch["tokens"].shape[0] // accum
        r = res.for_batch(n, batch["tokens"].shape[1])
        got = dict(rows=(r.tokens.rows.start, r.tokens.rows.stop),
                   stretch=r.tokens.stretch, axes=r.tokens.axes)
        if accum == 1:
            (total, m), grads = S.make_grad_fn(cfg, r)(
                params, {k: v[r.tokens.rows] for k, v in batch.items()})
            got.update(total=float(total), loss=float(m["loss"]),
                       aux=float(m["aux"]),
                       grads={k: v.numpy() for k, v in grads.items()})
        opt = OptConfig(**OPT)
        step = S.make_train_step(cfg, opt, res=res, accum_steps=accum)
        with op_cost.OpCost() as oc:
            state, metrics = step(init_state(params, opt), batch)
        got.update(params={k: v.detach().numpy()
                           for k, v in state.params.named_parameters()},
                   metrics={k: float(v) for k, v in metrics.items()},
                   collectives=oc.summary()["collectives"])
        out[cid] = got
    return out


def seq_cases(rank, world, case_dir):
    """Rank ``rank`` of every case on (2, 2)."""
    torch.set_num_threads(1)
    return dict(train=_train(rank, case_dir, SEQ_CASES, SEQ_MESH),
                modules=sorted(sys.modules))


def pod_cases(rank, world, case_dir):
    """Rank ``rank`` of every case on (2, 1, 2): the trainings, and the
    served llama's rows of the prefill's and decode steps' logits."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.collectives import sharded_run

    torch.set_num_threads(1)
    out = dict(train=_train(rank, case_dir, POD_CASES, POD_MESH))
    cfg = dataclasses.replace(get_smoke(SERVE_ARCH), **GQA)
    tree, extra = _load(case_dir, "serve")
    res = sharded_run(cfg, mesh(POD_MESH), rank=rank,
                      group=dist.group.WORLD)
    params = params_from_jax(cfg, tree, device="cpu", res=res)
    rows = res.rows(SERVE_B)
    t = torch.from_numpy(extra["tokens"][rows])
    with torch.inference_mode():
        cache = T.init_cache(cfg, SERVE_B, SERVE_P + SERVE_STEPS,
                             device="cpu", res=res)
        lg, cache = T.prefill(cfg, params, t[:, :SERVE_P], cache, res=res)
        outs = [lg]
        for i in range(SERVE_P, SERVE_P + SERVE_STEPS):
            lg, cache = T.decode_step(cfg, params, t[:, i:i + 1], cache, i,
                                      res=res)
            outs.append(lg)
    out["serve"] = dict(rows=(rows.start, rows.stop),
                        logits=torch.stack(outs).numpy())
    out["modules"] = sorted(sys.modules)
    return out
