"""Training launcher, the JAX package's ``launch/train.py`` on PyTorch.

Single-process trainer with checkpoint/restart and optional
heterogeneity-aware co-execution (the paper's technique as the DP layer).
The weights are random, of the published shapes, drawn from a
``torch.Generator`` seeded with 0, on ``--device`` (a card unless
``--device cpu``); every ``--hetero`` group runs on that device too.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 50 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --hetero cpu:1,igpu:2,gpu:4 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 2 --seq 4096 --batch 4 --accum 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import DeviceGroup
from repro_torch.core.hetero_dp import HeteroDPTrainer
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.training.step import make_train_step


def parse_hetero(spec: str, device="cuda:0"):
    groups = []
    for part in spec.split(","):
        name, throttle = part.split(":")
        groups.append(DeviceGroup(name, device=device,
                                  throttle=float(throttle)))
    return groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--hetero", default="",
                    help="co-execution groups, e.g. cpu:4,igpu:2,gpu:1 "
                         "(name:throttle)")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda:0",
                    help="device of the weights and every --hetero group")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train",
                        accum_steps=args.accum)
    pipeline = SyntheticPipeline(cfg, shape)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
    state = adamw.init_state(params, opt)
    total, active = T.param_count(cfg)
    print(f"arch={cfg.name} params={total/1e6:.1f}M "
          f"(active {active/1e6:.1f}M) tokens/step={args.batch*args.seq}")

    start_step = 0
    ck = CK.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if (args.resume and args.ckpt_dir
            and CK.latest_step(args.ckpt_dir) is not None):
        state, start_step = CK.restore(state, args.ckpt_dir)
        print(f"resumed from step {start_step}")

    t0 = time.time()
    if args.hetero:
        groups = parse_hetero(args.hetero, device)
        trainer = HeteroDPTrainer(cfg, opt, shape, groups, pipeline,
                                  compress=args.compress)
        try:
            for step in range(start_step, args.steps):
                state, rep = trainer.step(state, step)
                if step % args.log_every == 0:
                    rows = " ".join(f"{k}:{v}"
                                    for k, v in rep.device_rows.items())
                    print(f"step {step:5d} loss={rep.loss:.4f} "
                          f"t={rep.step_time_s*1e3:.0f}ms "
                          f"balance={rep.balance:.2f} "
                          f"packets={rep.packets} rows[{rows}]")
                if ck and step and step % args.ckpt_every == 0:
                    ck.save(state, step)
        finally:
            trainer.close()
    else:
        step_fn = make_train_step(cfg, opt, accum_steps=args.accum,
                                  compress=args.compress)
        for step in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in pipeline.batch_at(step).items()}
            state, metrics = step_fn(state, batch)
            if step % args.log_every == 0:
                loss = float(metrics["loss"])
                tok_s = args.batch * args.seq * (step - start_step + 1) \
                    / (time.time() - t0)
                print(f"step {step:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} tok/s={tok_s:.0f}")
            if ck and step and step % args.ckpt_every == 0:
                ck.save(state, step)
    if ck:
        ck.save(state, args.steps)
        ck.wait()
        print(f"checkpoint at {args.ckpt_dir} step {args.steps}")
    print(f"done in {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
