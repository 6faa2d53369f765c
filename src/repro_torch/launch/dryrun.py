"""The planner: what one (arch x shape x mesh) cell needs per device, the
JAX package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell's step on a mesh of 512
placeholder devices and reads XLA's memory analysis and its HLO.  The
port has no compiler to ask: :func:`plan_cell` runs the cell's step
itself on the ``meta`` device, where tensors have shapes and no data,
under ``op_cost.OpCost``:

* train: ``training/step.py``'s loss, ``torch.autograd.grad`` over
  ``cfg.accum_override or shape.accum_steps`` microbatches and AdamW;
* prefill: ``prefill`` into a cache of ``seq_len``;
* decode: one ``decode_step`` at the cache's last position.

The hand-written kernels answer ``meta`` calls with their outputs' shapes
and their least operations and bytes (``kernels.build.tally``), never the
plain version's intermediates.  Per-device argument bytes come from the
sharding resolver over the state's logical axes, with the JAX package's
resolvers: FSDP for training, ``serve_2d_weights`` for prefill.  Nothing
is allocated and no card is needed.

A cell on a mesh with an axis above 1 also runs rank 0's own step
(``sharded_step``): its block of the weights and cache
(``transformer.shard_params``, ``init_cache(res=...)``) or of the
training state (the blocks, their AdamW moments) on ``meta``, on its
rows of the batch where "pod" or "data" exceeds 1 (a train step takes
the whole batch and runs the rank's part of each microbatch: its block
of the rows, or its stretch of the positions where the batch axes do
not divide the rows), its collectives under a ``fake``-backend group of
the mesh's size and the "model", "data" and "pod" groups made from it,
counted by ``OpCost`` (a train step's forward, backward and remat
recompute alike, the FSDP gathers and reduce-scatters over "data" among
them); the record's ``collectives`` are that step's.  A config that
``transformer.check_shardable`` (serving) or ``check_trainable``
(training) refuses keeps ``{}`` and records why.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch deepseek-v2-lite-16b --shape train_4k --mesh h100x4 \\
        --set n_layers=3

writes one JSON record a cell under ``--out`` (``artifacts/dryrun``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import op_cost
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import CARD_MESHES, card_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel import spmd
from repro_torch.parallel.collectives import sharded_run
from repro_torch.parallel.sharding import Mesh, ShardingResolver
from repro_torch.training import step as STEP

GB = 1e9


def resolver_for(cfg: ModelConfig, shape: ShapeConfig,
                 mesh: Mesh) -> ShardingResolver:
    """The JAX package's resolver of a cell: FSDP for training and for
    prefill of ``serve_2d_weights`` configs (weights spread over data,
    the batch amortising the gathers), tensor-parallel weights else."""
    fsdp = shape.kind == "train" or (shape.kind == "prefill"
                                     and cfg.serve_2d_weights)
    return ShardingResolver(mesh, fsdp=fsdp)


def _bytes(res, cfg, tree, axes, *, param, rounded=False) -> int:
    """Per-device bytes of ``tree``; with ``rounded`` each tensor's bytes
    rounded up as the CUDA caching allocator rounds them (one card)."""
    if not rounded:
        return SP.per_device_bytes(res, cfg, tree, axes, param=param)
    return sum(op_cost.rounded_bytes(t.numel() * t.element_size())
               for _, t, _ in SP.named_tensors(tree, axes))


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
                   opt: Optional[OptConfig] = None,
                   rounded: bool = False) -> Dict[str, int]:
    """Per-device bytes of the cell's step arguments by part (inputs,
    params, moments and step, or cache), the cell's resolver on
    ``mesh``; with ``rounded`` (one card) each tensor's bytes rounded up
    as the CUDA caching allocator rounds them."""
    return _arguments(cfg, shape, resolver_for(cfg, shape, mesh),
                      opt or OptConfig(), rounded=rounded)


def _arguments(cfg, shape, res, opt, *, rounded=False) -> Dict[str, int]:
    """Per-device argument bytes by part."""
    ins = SP.input_specs(cfg, shape)
    in_axes = SP.batch_logical_axes(cfg, shape)
    if shape.kind == "decode":     # the token and position: replicated
        in_axes = {k: (None,) * len(ax) for k, ax in in_axes.items()}
    out = {"inputs": _bytes(res, cfg, ins, in_axes, param=False,
                            rounded=rounded)}
    if shape.kind == "train":
        st, ax = SP.abstract_train_state(cfg, opt)
        out["params"] = _bytes(res, cfg, st.params, ax.params, param=True,
                               rounded=rounded)
        out["moments"] = 2 * _bytes(res, cfg, st.mu, ax.mu, param=True,
                                    rounded=rounded)
        out["step"] = _bytes(res, cfg, st.step, ax.step, param=True,
                             rounded=rounded)
        return out
    params, p_axes = (SP.abstract_params_unstacked(cfg) if
                      shape.kind == "decode" and cfg.decode_unroll
                      else SP.abstract_params(cfg))
    cache, c_axes = SP.abstract_cache(cfg, shape.global_batch,
                                      shape.seq_len)
    out["params"] = _bytes(res, cfg, params, p_axes, param=True,
                           rounded=rounded)
    out["cache"] = _bytes(res, cfg, cache, c_axes, param=False,
                          rounded=rounded)
    return out


def _gradient_bytes(cfg, res, opt, accum: int) -> Dict[str, int]:
    """Per-device bytes of one set of gradients (the parameters' dtype)
    and, when microbatches are accumulated, of the float32 sums."""
    st, ax = SP.abstract_train_state(cfg, opt)
    grads = _bytes(res, cfg, st.params, ax.params, param=True)
    out = {"gradients": grads}
    if accum > 1:
        f32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for n, p in st.params.named_parameters()}
        out["grad_sums"] = _bytes(res, cfg, f32, ax.params, param=True)
    return out


def run_step(cfg: ModelConfig, shape: ShapeConfig,
             opt: Optional[OptConfig] = None, res=None) -> op_cost.OpCost:
    """The cell's step on ``meta`` under :class:`op_cost.OpCost`; the
    state and inputs are made before the mode starts, so its peak is of
    what the step allocates beside them.  With ``res`` the step of that
    rank of the sharded model."""
    opt = opt or OptConfig()
    ins = SP.input_specs(cfg, shape)
    if shape.kind == "train":
        state, _ = SP.abstract_train_state(cfg, opt)
        if res is not None:
            state = adamw.init_state(T.shard_params(cfg, state.params, res),
                                     opt)
        fn = STEP.make_train_step(cfg, opt, res=res,
                                  accum_steps=cfg.accum_override
                                  or shape.accum_steps)
        with op_cost.OpCost() as oc:
            fn(state, ins)
    else:
        params, _ = SP.abstract_params(cfg)
        if res is not None:
            params = T.shard_params(cfg, params, res)
            if res.data_size > 1 or res.pod_size > 1:   # the rank's rows
                ins = {k: v[res.rows(v.shape[0])] if v.dim() else v
                       for k, v in ins.items()}
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=SP.META, res=res)
        with op_cost.OpCost() as oc:
            if shape.kind == "prefill":
                STEP.make_prefill_step(cfg, res=res)(params, ins, cache)
            elif shape.kind == "decode":
                STEP.make_decode_step(cfg, res=res)(
                    params, ins["token"], cache, shape.seq_len - 1)
            else:
                raise ValueError(shape.kind)
    return oc


def sharded_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                 arg_bytes: int) -> Dict:
    """Rank 0's step of a cell split over ``mesh`` (the module's
    docstring): its totals, collectives and predicted peak
    (``arg_bytes``, a device's arguments, plus what the step holds), or
    ``{"refused": why}``."""
    train = shape.kind == "train"
    try:
        if train:
            T.check_trainable(cfg, mesh, shape.global_batch,
                              cfg.accum_override or shape.accum_steps)
        else:
            T.check_shardable(cfg, mesh)
    except ValueError as e:
        return {"refused": str(e)}
    with spmd.fake_group(mesh.size) as group:
        res = sharded_run(cfg, mesh, group=group, train=train,
                          prefill=shape.kind == "prefill")
        oc = run_step(cfg, shape, res=res)
    s = oc.summary()
    out = {k: s[k] for k in ("flops", "dot_flops", "traffic_bytes",
                             "peak_held_bytes", "kernels", "collectives",
                             "collective_wire_bytes")}
    out.update(meta_run_s=oc.seconds, op_histogram=oc.op_histogram(),
               predicted_peak_bytes=arg_bytes + s["peak_held_bytes"])
    return out


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
         opt: Optional[OptConfig] = None,
         cost: Optional[op_cost.OpCost] = None) -> Dict:
    """The record of one cell (the module's docstring); ``cost``: a
    :func:`run_step` of the same cell to reuse (the step's cost does not
    depend on the mesh)."""
    T.check_supported(cfg)
    opt = opt or OptConfig()
    t0 = time.perf_counter()
    res = resolver_for(cfg, shape, mesh)
    args = _arguments(cfg, shape, res, opt)
    accum = (cfg.accum_override or shape.accum_steps
             if shape.kind == "train" else 1)
    if shape.kind == "train":
        args.update(_gradient_bytes(cfg, res, opt, accum))
    arg_bytes = sum(v for k, v in args.items()
                    if k not in ("gradients", "grad_sums"))
    cost = cost or run_step(cfg, shape, opt)
    summary = cost.summary()
    n = mesh.size
    record = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh.tag,
        "n_devices": n,
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "n_layers": cfg.n_layers,
        "accum_steps": accum,
        "plan_s": 0.0,
        "meta_run_s": cost.seconds,
        "per_device_bytes": args,
        "argument_bytes_per_device": arg_bytes,
        # the whole step's totals and an even share of them a device (a
        # cell split over the mesh also has rank 0's own step under
        # "sharded_step", and its collectives here)
        "flops": summary["flops"],
        "dot_flops": summary["dot_flops"],
        "transcendentals": summary["transcendentals"],
        "traffic_bytes": summary["traffic_bytes"],
        "flops_per_device": summary["flops"] / n,
        "collectives": summary["collectives"],
        "collective_wire_bytes_per_device": 0.0,
        "kernels": summary["kernels"],
        "op_histogram": cost.op_histogram(),
        # what the step allocates and holds at once beside its
        # arguments (rounded as the caching allocator rounds), and the
        # predicted peak of a device: its arguments and an even share
        "step_peak_bytes": summary["peak_held_bytes"],
        "predicted_peak_bytes_per_device":
            arg_bytes + summary["peak_held_bytes"] / n,
    }
    if any(n > 1 for n in mesh.shape):
        step = record["sharded_step"] = sharded_step(cfg, shape, mesh,
                                                     arg_bytes)
        if "refused" not in step:
            record["collectives"] = step["collectives"]
            record["collective_wire_bytes_per_device"] = step[
                "collective_wire_bytes"]
    if n == 1:
        rounded = _arguments(cfg, shape, res, opt, rounded=True)
        record["argument_bytes_allocated"] = sum(rounded.values())
        record["predicted_peak_bytes_per_device"] = (
            record["argument_bytes_allocated"] + summary["peak_held_bytes"])
    record["plan_s"] = time.perf_counter() - t0
    return record


def plan_cell(arch: str, shape_name: str, mesh: Mesh, *,
              overrides: Optional[Dict] = None) -> Dict:
    """:func:`plan` of a named cell, ``overrides`` (``--set``) applied to
    its config."""
    cfg = get_config(arch)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return plan(cfg, SHAPES[shape_name], mesh)


def plan_meshes(arch: str, shape_name: str, mesh_names=("h100", "h100x4"),
                overrides: Optional[Dict] = None) -> List[Dict]:
    """:func:`plan_cell` on each of the named card meshes, the step run
    once (its cost does not depend on the mesh)."""
    cfg = get_config(arch)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    cost = run_step(cfg, shape)
    return [plan(cfg, shape, card_mesh(m), cost=cost) for m in mesh_names]


def cell_list():
    cells = []
    for arch in ARCH_IDS:
        for shape in shapes_for(get_config(arch)):
            cells.append((arch, shape.name))
    return cells


def _parse_overrides(pairs):
    """--set key=value config overrides (ints/floats/bools/strings; nested
    moe.* / ssm.* fields supported)."""
    out = {}
    for pair in pairs or []:
        key, val = pair.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if val in ("true", "True"):
            val = True
        if val in ("false", "False"):
            val = False
        out[key] = val
    return out


def apply_overrides(cfg, overrides):
    top = {}
    for key, val in overrides.items():
        if "." in key:
            sub, field_name = key.split(".", 1)
            top[sub] = dataclasses.replace(getattr(cfg, sub),
                                           **{field_name: val})
        else:
            top[key] = val
    return dataclasses.replace(cfg, **top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="h100", choices=sorted(CARD_MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", dest="overrides",
                    help="cfg override key=value (repeatable); e.g. "
                         "--set n_layers=3 --set moe.capacity_factor=1.0")
    ap.add_argument("--tag", default="",
                    help="artifact suffix for perf iterations")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = cell_list() if args.all else [(args.arch, args.shape)]
    mesh = card_mesh(args.mesh)
    os.makedirs(args.out, exist_ok=True)
    overrides = _parse_overrides(args.overrides)
    failures = 0
    for arch, shape in cells:
        suffix = f"__{args.tag}" if args.tag else ""
        fp = os.path.join(args.out,
                          f"{arch}__{shape}__{args.mesh}{suffix}.json")
        if os.path.exists(fp) and not args.force:
            print(f"[skip] {fp}")
            continue
        print(f"[plan] {arch} x {shape} x {args.mesh} {overrides} ...",
              flush=True)
        try:
            rec = plan_cell(arch, shape, mesh, overrides=overrides or None)
            rec["overrides"] = overrides
            rec["tag"] = args.tag
            with open(fp, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"  ok: {rec['plan_s']:.2f} s, args/dev "
                  f"{rec['argument_bytes_per_device'] / GB:.3f} GB, peak/dev "
                  f"{rec['predicted_peak_bytes_per_device'] / GB:.3f} GB, "
                  f"flops {rec['flops']:.3e} (dots "
                  f"{rec['dot_flops']:.3e})", flush=True)
        except Exception:
            failures += 1
            print(f"  FAILED:\n{traceback.format_exc()}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
