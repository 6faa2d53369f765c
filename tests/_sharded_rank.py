"""Rank bodies of ``tests/test_torch_sharded.py``: what each of the four
gloo ranks runs on the CPU.  The ranks are spawned processes that import
this module, so it imports ``repro_torch`` and never ``jax`` or
``repro`` (each rank checks that neither is loaded)."""
import dataclasses
import sys

import numpy as np
import torch

# the smoke configs served sharded; GQA ones at 8/4 heads, so that the kv
# heads divide over four ranks (stablelm-3b is MHA at 4 kv heads)
ARCHS = ["llama3.2-1b", "qwen3-32b", "yi-9b", "stablelm-3b", "dbrx-132b",
         "falcon-mamba-7b", "jamba-v0.1-52b", "musicgen-large"]
HEADS = dict(n_heads=8, n_kv_heads=4)
WORLD = 4
# batch, prompt and teacher-forced decode steps (the dense cell's B and S
# are those of the JAX package's collectives it is held to)
B, P, STEPS = 4, 32, 3


def with_heads(cfg):
    """``cfg`` at ``HEADS`` where it has grouped kv heads."""
    if cfg.attn_kind == "gqa" and cfg.n_kv_heads != cfg.n_heads:
        return dataclasses.replace(cfg, **HEADS)
    return cfg


def flatten(tree, prefix=""):
    """A nested dict/list tree of arrays -> {"a/b/#0/c": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat):
    """:func:`flatten`'s inverse."""
    root = {}
    for key, arr in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.startswith("#") for k in n):
            return [lists(n[f"#{i}"]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def teacher_forced(cfg, params, tokens, res=None):
    """Prefill ``P`` tokens, then ``STEPS`` decode steps fed the next
    tokens.  Returns (the logits of each, stacked; the prefill's and the
    first decode step's ``OpCost`` summaries; every MoE routing's chosen
    experts)."""
    from repro_torch.launch import op_cost
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    routes, route = [], L.moe_route

    def recorded(cfg_, p, x):
        out = route(cfg_, p, x)
        routes.append(out[2].numpy().copy())
        return out

    tokens = torch.from_numpy(tokens)
    L.moe_route = recorded
    try:
        with torch.inference_mode():
            cache = T.init_cache(cfg, B, P + STEPS, device="cpu", res=res)
            with op_cost.OpCost() as pre:
                lg, cache = T.prefill(cfg, params, tokens[:, :P], cache,
                                      res=res)
            outs, costs = [lg], [pre.summary()]
            for i in range(P, P + STEPS):
                with op_cost.OpCost() as oc:
                    lg, cache = T.decode_step(cfg, params,
                                              tokens[:, i:i + 1], cache, i,
                                              res=res)
                outs.append(lg)
                costs.append(oc.summary())
    finally:
        L.moe_route = route
    return torch.stack(outs).numpy(), costs[:2], routes


def serve_cases(rank, world, case_dir, archs):
    """Rank ``rank`` of each config in ``archs``: its block of the JAX
    package's parameters (``{case_dir}/{arch}.npz``), the teacher-forced
    run of :func:`teacher_forced` on it.  Returns by arch the logits,
    routes and the collectives of prefill and decode."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.collectives import sharded_run

    torch.set_num_threads(1)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    if leaked:
        raise RuntimeError(f"rank {rank} imported {leaked}")
    out = {}
    for arch in archs:
        cfg = with_heads(get_smoke(arch))
        with np.load(f"{case_dir}/{arch}.npz") as data:
            flat = {k: data[k] for k in data.files}
        tokens = flat.pop("__tokens__")
        res = sharded_run(cfg, make_test_mesh(world), rank=rank,
                          group=dist.group.WORLD)
        params = params_from_jax(cfg, unflatten(flat), device="cpu",
                                 res=res)
        logits, (pre, dec), routes = teacher_forced(cfg, params, tokens,
                                                    res)
        out[arch] = dict(logits=logits, routes=routes,
                         prefill=pre["collectives"],
                         decode=dec["collectives"],
                         param_bytes=sum(p.numel() * p.element_size()
                                         for p in params.parameters()))
    out["modules"] = sorted(sys.modules)
    return out


def sum_of_ranks(rank, world):
    """(rank, world, the all-reduced sum of every rank's rank + 1)."""
    import torch.distributed as dist

    c = torch.ops._c10d_functional
    x = torch.tensor([float(rank + 1)])
    y = c.wait_tensor(c.all_reduce(x, "sum", dist.group.WORLD.group_name))
    return rank, world, float(y[0])


def rank_two_fails(rank, world):
    """Rank 2 raises; the others wait for it at a barrier forever."""
    import torch.distributed as dist

    if rank == 2:
        raise ValueError("rank two fails on purpose")
    dist.barrier()


def never_returns(rank, world):
    import time
    time.sleep(3600)
