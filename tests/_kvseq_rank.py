"""Rank bodies of ``tests/test_torch_sharded_kvseq.py``: what each of the
four gloo ranks runs on the CPU for the configs whose caches the
resolver splits by positions.  The ranks are spawned processes that
import this module, so it imports ``repro_torch`` and never ``jax`` or
``repro`` (each rank checks that neither is loaded)."""
import sys

import numpy as np
import torch

from _sharded_rank import unflatten

# internvl2-1b (GQA at its smoke 2/1 heads: neither splits, so the cache
# splits by positions) and deepseek-v2-lite-16b (MLA: its latent cache
# has no heads to split)
ARCHS = ["internvl2-1b", "deepseek-v2-lite-16b"]
WORLD = 4
# a cache of 16 splits into stretches of 4: the prompt of 5 fills rank 0's
# and one row of rank 1's, ranks 2 and 3 start empty, and the 8 decode
# steps (positions 5 ... 12) cross into ranks 2 and 3
B, P, STEPS = 2, 5, 8
SPLIT_SEQ = 16
# P + STEPS does not divide by 4: the resolver keeps every position on
# every rank
WHOLE_SEQ = 35


def run_cache(cfg, params, tokens, max_seq, res=None):
    """Prefill ``P`` tokens into a cache of ``max_seq``, then ``STEPS``
    teacher-forced decode steps.  Returns (the logits of each, stacked;
    the cache's entries right after the prefill, copied; every MoE
    routing's chosen experts)."""
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
            cache = T.init_cache(cfg, B, max_seq, device="cpu", res=res)
            lg, cache = T.prefill(cfg, params, tokens[:, :P], cache, res=res)
            after = [{k: t.numpy().copy() for k, t in c.items()}
                     for c in cache]
            outs = [lg]
            for i in range(P, P + STEPS):
                lg, cache = T.decode_step(cfg, params, tokens[:, i:i + 1],
                                          cache, i, res=res)
                outs.append(lg)
    finally:
        L.moe_route = route
    return torch.stack(outs).numpy(), after, routes


def planned_cell(cfg, params, tokens, res):
    """The collectives ``OpCost`` counts on this rank in a prefill of a
    whole cache of ``SPLIT_SEQ`` and a decode step at its last position:
    the planner's prefill and decode cells of that shape."""
    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T

    t = torch.from_numpy(np.resize(tokens, (B, SPLIT_SEQ)))
    out = {}
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, SPLIT_SEQ, device="cpu", res=res)
        with op_cost.OpCost() as oc:
            T.prefill(cfg, params, t, cache, res=res)
        out["prefill"] = oc.summary()["collectives"]
        with op_cost.OpCost() as oc:
            T.decode_step(cfg, params, t[:, -1:], cache, SPLIT_SEQ - 1,
                          res=res)
        out["decode"] = oc.summary()["collectives"]
    return out


def kvseq_cases(rank, world, case_dir):
    """Rank ``rank`` of each config in ``ARCHS``: its block of the JAX
    package's parameters (``{case_dir}/{arch}.npz``), the teacher-forced
    run of :func:`run_cache` on a split cache and on a whole one, its
    stretch, cache shapes and the planner cells' collectives."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.collectives import sharded_run

    torch.set_num_threads(1)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    if leaked:
        raise RuntimeError(f"rank {rank} imported {leaked}")
    out = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        with np.load(f"{case_dir}/{arch}.npz") as data:
            flat = {k: data[k] for k in data.files}
        tokens = flat.pop("__tokens__")
        res = sharded_run(cfg, make_test_mesh(world), rank=rank,
                          group=dist.group.WORLD)
        params = params_from_jax(cfg, unflatten(flat), device="cpu",
                                 res=res)

        def stretch(max_seq):
            # layer 0's first entry (an attention layer in both configs)
            meta = T.init_cache(cfg, B, max_seq, device="meta")
            name, axes = next(iter(T.cache_axes(cfg, meta)[0].items()))
            return res.kv_stretch(axes, meta[0][name].shape)

        split, split_cache, split_routes = run_cache(cfg, params, tokens,
                                                     SPLIT_SEQ, res)
        kept, _, _ = run_cache(cfg, params, tokens, WHOLE_SEQ, res)
        out[arch] = dict(
            split=split, kept=kept, cache=split_cache, routes=split_routes,
            stretch=stretch(SPLIT_SEQ), kept_stretch=stretch(WHOLE_SEQ),
            plan=planned_cell(cfg, params, tokens, res))
    out["modules"] = sorted(sys.modules)
    return out
