#!/usr/bin/env python3
"""Two device groups on one card: each group on a stream of its own,
waiting on its own packet's work (``DeviceGroup.run_packet``), against
the earlier semantics, every packet on the card's current stream and a
``torch.cuda.synchronize`` of the whole card before the packet's time is
read.  Both run in one process, in turns (card, own, own, card), on
llama3.2-1b at full width in bfloat16 with random weights (seed 0):

* training: ``HeteroDPTrainer`` with two groups (throttles 1 and 2) at
  TRAIN_4K's 4,096 tokens, a global batch of 8, lws 1, AdamW; the mean
  step time of steps 2-N.  Under the earlier semantics the groups also
  share the parameters' leaves, as they did;
* serving: ``CoexecServer`` with two replicas (throttles 1 and 2), 16
  requests at t=0, prompt 256, 32 tokens, lws 4; the run's duration.

For each turn it prints each group's busy time on the host clock, the
caching allocator's retries (a retry frees cached blocks and synchronises
the card) and its peak of reserved memory.  Needs one card:

    python3 group_streams.py [--steps 6] [--rounds 2]

The last line is one JSON object with every turn's numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SERVE = dict(requests=16, prompt=256, gen=32, lws=4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("group_streams: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TRAIN_4K, ShapeConfig
    from repro_torch.core.device import DeviceGroup
    from repro_torch.core.hetero_dp import HeteroDPTrainer
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve import (CoexecServer, Replica, RequestQueue,
                                   ServerConfig, make_requests)

    class CardSyncGroup(DeviceGroup):
        """The earlier packet timing: the card's current stream and a
        synchronize of the whole card."""

        def run_packet(self, fn, offset, size):
            t0 = time.perf_counter()
            out = fn(offset, size)
            torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if self.throttle > 1.0:
                time.sleep(dt * (self.throttle - 1.0))
                dt *= self.throttle
            self.packets_done += 1
            self.busy_time += dt
            wg_per_s = size / max(dt, 1e-9)
            self.throughput = wg_per_s if self.throughput is None else (
                self.ewma * wg_per_s + (1 - self.ewma) * self.throughput)
            return out, wg_per_s

    dev0 = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = get_config("llama3.2-1b")
    shape = ShapeConfig("train_4k_batch8", TRAIN_4K.seq_len, 8, "train")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=args.steps + 2)

    def alloc():
        st = torch.cuda.memory_stats(dev0)
        return st.get("num_alloc_retries", 0)

    def train(kind):
        group = CardSyncGroup if kind == "card" else DeviceGroup
        params = T.init_params(cfg, torch.Generator(dev0).manual_seed(0))
        state = adamw.init_state(params, opt)
        groups = [group("g0", device=dev0, throttle=1.0),
                  group("g1", device=dev0, throttle=2.0)]
        pipeline = SyntheticPipeline(cfg, shape, DataConfig(seed=1234))
        trainer = HeteroDPTrainer(cfg, opt, shape, groups, pipeline, lws=1)
        if kind == "card":      # the groups share the parameters' leaves
            trainer._params_on = lambda p, g: p
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev0)
        r0 = alloc()
        times = []
        try:
            for i in range(args.steps):
                state, rep = trainer.step(state, i)
                times.append(rep.step_time_s)
        finally:
            trainer.close()
        res = dict(step_s=times, mean_steps_2_on=float(np.mean(times[1:])),
                   busy_s={g.name: g.busy_time for g in groups},
                   alloc_retries=alloc() - r0,
                   reserved_peak_gb=torch.cuda.max_memory_reserved(dev0)
                   / 1e9, loss=rep.loss)
        del trainer, state, params, groups
        torch.cuda.empty_cache()
        return res

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE["requests"], SERVE["prompt"])).astype(
            np.int32)

    def serve(kind):
        import repro_torch.serve.server as S
        params = T.init_params(cfg, torch.Generator(dev0).manual_seed(0))
        reps = [Replica("r0", cfg, params, throttle=1.0, device=dev0),
                Replica("r1", cfg, params, throttle=2.0, device=dev0)]
        for r in reps:         # warm-up outside the run
            r.serve(prompts[:SERVE["lws"]], SERVE["gen"],
                    SERVE["prompt"] + SERVE["gen"])
        group = S.DeviceGroup
        S.DeviceGroup = CardSyncGroup if kind == "card" else DeviceGroup
        try:
            server = CoexecServer(reps, ServerConfig(
                scheduler="hguided_deadline", lws=SERVE["lws"],
                gen=SERVE["gen"], policy="none", warmup=False))
        finally:
            S.DeviceGroup = group
        reqs = make_requests([0.0] * SERVE["requests"], slo=600.0,
                             prompt_fn=lambda i: prompts[i])
        torch.cuda.synchronize()
        r0 = alloc()
        try:
            out = server.run(RequestQueue(reqs))
            busy = {g.name: g.busy_time for g in server.session.devices}
        finally:
            server.close()
        check = out.stats.served == SERVE["requests"]
        del reps, params, server
        torch.cuda.empty_cache()
        return dict(duration_s=out.stats.duration, served_all=check,
                    busy_s=busy, alloc_retries=alloc() - r0)

    turns = []
    order = (["card", "own", "own", "card"] * args.rounds)[:2 * args.rounds]
    for kind in order:
        t = dict(kind=kind, serve=serve(kind), train=train(kind))
        turns.append(t)
        print(f"{kind}: serve {t['serve']['duration_s']:.3f} s (busy "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          t['serve']['busy_s'].items())
              + f"; alloc retries {t['serve']['alloc_retries']}); train "
              f"steps {[round(x, 3) for x in t['train']['step_s']]} s, "
              f"mean of 2-{args.steps} {t['train']['mean_steps_2_on']:.3f}"
              f" s (busy " + ", ".join(
                  f"{k} {v:.3f}" for k, v in t['train']['busy_s'].items())
              + f"; alloc retries {t['train']['alloc_retries']}, reserved "
              f"peak {t['train']['reserved_peak_gb']:.2f} GB)", flush=True)
    if not all(t["serve"]["served_all"] for t in turns):
        print("group_streams: a serving turn left requests unserved",
              file=sys.stderr)
        return 1
    print(json.dumps({"device": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
