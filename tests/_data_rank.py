"""Rank bodies of ``tests/test_torch_sharded_data.py``: what each of the
four gloo ranks runs on the CPU on the ("data", "model") = (2, 2) mesh.
The ranks are spawned processes that import this module, so it imports
``repro_torch`` and never ``jax`` or ``repro`` (each rank returns the
modules it loaded, which the test reads)."""
import dataclasses
import sys

import numpy as np
import torch

import _kvseq_rank as K
import _sharded_rank as SR
import _sharded_train_rank as TR

WORLD = 4
MESH_SHAPE = (2, 2)
# serving: the dense, MoE, Mamba and hybrid configs of
# ``tests/_sharded_rank.py`` at B = 4 (2 rows a "data" rank), a prompt of
# ``SR.P`` and ``SR.STEPS`` teacher-forced steps; a batch of 1, which
# "data" does not divide, replicated over "data"
ONE_ROW = ["llama3.2-1b", "deepseek-v2-lite-16b"]
# dbrx-132b's prefill from the FSDP blocks of ``serve_2d_weights``
FSDP_PREFILL = "dbrx-132b"
# the configs of ``tests/_kvseq_rank.py``; internvl2-1b at 3/1 heads,
# which do not split over "model" = 2, so that its GQA cache splits by
# positions as its 2/1 heads' does over four ranks
KVSEQ_HEADS = {"internvl2-1b": dict(n_heads=3, n_kv_heads=1)}


def kvseq_config(get, arch):
    """``arch``'s smoke config from ``get`` (either package's
    ``get_smoke``) at :data:`KVSEQ_HEADS`."""
    return dataclasses.replace(get(arch), **KVSEQ_HEADS.get(arch, {}))


def mesh():
    from repro_torch.parallel.sharding import Mesh
    return Mesh(("data", "model"), MESH_SHAPE)


def forced(cfg, params, tokens, batch, prompt, max_seq, res):
    """Prefill ``prompt`` tokens of the rank's rows ``tokens`` into the
    rank's cache of a batch of ``batch`` and ``max_seq`` positions, then
    teacher-forced decode steps for the rest: the logits of each,
    stacked (numpy)."""
    from repro_torch.models import transformer as T
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        cache = T.init_cache(cfg, batch, max_seq, device="cpu", res=res)
        lg, cache = T.prefill(cfg, params, t[:, :prompt], cache, res=res)
        outs = [lg]
        for i in range(prompt, t.shape[1]):
            lg, cache = T.decode_step(cfg, params, t[:, i:i + 1], cache, i,
                                      res=res)
            outs.append(lg)
    return torch.stack(outs).numpy()


def _load(case_dir, name):
    with np.load(f"{case_dir}/{name}.npz") as data:
        flat = {k: data[k] for k in data.files}
    extra = {k[2:-2]: flat.pop(k) for k in [k for k in flat
                                           if k.startswith("__")]}
    return SR.unflatten(flat), extra


def _train(rank, case_dir):
    """Every case of ``tests/_sharded_train_rank.py`` on this rank: its
    FSDP blocks of the JAX package's parameters, the loss and gradients
    of its rows by ``make_grad_fn``, then one ``make_train_step`` of the
    whole batch (counted by ``OpCost``) from zero moments."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.parallel.collectives import sharded_run
    from repro_torch.training import step as S

    out = {}
    for case in TR.CASES:
        cid, _, _, step_kw, opt_kw = case
        cfg = TR.case_config(get_smoke, case)
        tree, batch = _load(case_dir, f"train-{cid}")
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        res = sharded_run(cfg, mesh(), rank=rank, group=dist.group.WORLD,
                          train=True)
        params = params_from_jax(cfg, tree, device="cpu", res=res)
        params.requires_grad_(True)
        fsdp = {n: p.fsdp[0] for n, p in params.named_parameters()
                if hasattr(p, "fsdp")}
        rows = res.rows(TR.B)
        (total, m), grads = S.make_grad_fn(cfg, res)(
            params, {k: v[rows] for k, v in batch.items()})
        opt = OptConfig(**TR.OPT, **opt_kw)
        state = init_state(params, opt)
        step = S.make_train_step(cfg, opt, res=res, **step_kw)
        with op_cost.OpCost() as oc:
            state, metrics = step(state, batch)
        out[cid] = dict(
            total=float(total), loss=float(m["loss"]), aux=float(m["aux"]),
            grads={k: v.numpy() for k, v in grads.items()},
            params={k: v.detach().numpy()
                    for k, v in state.params.named_parameters()},
            metrics={k: float(v) for k, v in metrics.items()},
            collectives=oc.summary()["collectives"], fsdp=fsdp,
            split=T.split_axes(cfg, res))
    return out


def _serve(rank, case_dir):
    """The serving cases on this rank: tensor-parallel blocks (the
    decode resolver), the rank's rows of each batch."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.collectives import sharded_run

    def setup(cfg, name, **kw):
        tree, extra = _load(case_dir, name)
        res = sharded_run(cfg, mesh(), rank=rank, group=dist.group.WORLD,
                          **kw)
        return res, params_from_jax(cfg, tree, device="cpu", res=res), extra

    out = {}
    for arch in SR.ARCHS:
        cfg = SR.with_heads(get_smoke(arch))
        res, params, extra = setup(cfg, f"serve-{arch}")
        tokens = extra["tokens"]
        rows = res.rows(SR.B)
        out[arch] = dict(rows=(rows.start, rows.stop), logits=forced(
            cfg, params, tokens[rows], SR.B, SR.P, SR.P + SR.STEPS, res))
        if arch in ONE_ROW:
            out[arch]["one_row"] = forced(cfg, params, tokens[:1], 1, SR.P,
                                          SR.P + SR.STEPS, res)
    for arch in K.ARCHS:
        cfg = kvseq_config(get_smoke, arch)
        res, params, extra = setup(cfg, f"kvseq-{arch}")
        tokens = extra["tokens"]
        rows = res.rows(K.B)
        split, _, _ = K.run_cache(cfg, params, tokens[rows], K.SPLIT_SEQ,
                                  res)
        kept, _, _ = K.run_cache(cfg, params, tokens[rows], K.WHOLE_SEQ,
                                 res)
        meta = T.init_cache(cfg, K.B, K.SPLIT_SEQ, device="meta")
        name, axes = next(iter(T.cache_axes(cfg, meta)[0].items()))
        out[arch] = dict(rows=(rows.start, rows.stop), split=split,
                         kept=kept, stretch=res.kv_stretch(
                             axes, meta[0][name].shape))
        if arch in ONE_ROW:
            out[arch]["one_row"] = forced(cfg, params, tokens[:1], 1, K.P,
                                          K.SPLIT_SEQ, res)
    cfg = SR.with_heads(get_smoke(FSDP_PREFILL))
    res, params, extra = setup(cfg, f"serve-{FSDP_PREFILL}", prefill=True)
    rows = res.rows(SR.B)
    t = torch.from_numpy(extra["tokens"][rows, :SR.P])
    with torch.inference_mode():
        cache = T.init_cache(cfg, SR.B, SR.P, device="cpu", res=res)
        lg, _ = T.prefill(cfg, params, t, cache, res=res)
    out["fsdp_prefill"] = dict(rows=(rows.start, rows.stop),
                               logits=lg.numpy(),
                               fsdp=sorted(n for n, p in
                                           params.named_parameters()
                                           if hasattr(p, "fsdp")))
    return out


def data_cases(rank, world, case_dir):
    """Rank ``rank`` of every training and serving case (the test's
    docstring)."""
    torch.set_num_threads(1)
    out = {"train": _train(rank, case_dir), "serve": _serve(rank, case_dir)}
    out["modules"] = sorted(sys.modules)
    return out
