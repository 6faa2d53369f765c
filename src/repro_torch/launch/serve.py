"""Serving launcher: thin CLI over the deadline-aware serving subsystem.

All mechanism lives in repro_torch.serve (workload generation, admission,
co-execution dispatch, accounting); this module only parses flags, builds
replicas and prints the outcome.  Every replica serves from one copy of
the weights on ``--device`` (a card unless ``--device cpu``), with
heterogeneity from its throttle.  The weights are random, of the
published shapes, drawn from a ``torch.Generator`` seeded with 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 16 --rate 50 --slo 10 \
      --replicas r0:1,r1:2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests 16 --prompt-len 256 --gen 32 --replicas r0:1,r1:2

``--arch qwen3-32b`` (q/k RMSNorm), ``yi-9b`` and ``stablelm-3b`` serve
the dense configs at full depth on one card (65.5, 17.7 and 5.6 GB of
bfloat16 weights); ``--arch dbrx-132b`` builds all 40 of its layers,
263 GB, more than one card (``chip_smoke.py`` serves its first 8).
``--arch deepseek-v2-lite-16b`` serves the MLA + MoE model the same way
(on a card: all 27 layers, 31.4 GB of bfloat16 weights), ``--arch
jamba-v0.1-52b`` the hybrid attention/Mamba period with MoE (its 32
layers hold 103.1 GB of bfloat16 weights, more than one card) and
``--arch internvl2-1b`` the VLM without patch embeddings, as the JAX
package's server serves it.  ``--arch musicgen-large`` is refused with
``ValueError`` before its weights are built: its positions hold 4
codebooks, and replicas serve one token a position.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.scheduler import available_schedulers
from repro_torch.models import transformer as T
from repro_torch.serve import (ARRIVALS, CoexecServer, Replica, RequestQueue,
                         ServerConfig, make_requests, trace_arrivals)
from repro_torch.serve.replica import check_servable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--replicas", default="r0:1",
                    help="name:throttle list, e.g. r0:1,r1:2")
    ap.add_argument("--lws", type=int, default=4,
                    help="requests per packet alignment")
    ap.add_argument("--scheduler", default="hguided_deadline",
                    choices=available_schedulers())
    ap.add_argument("--arrival", default="poisson",
                    choices=sorted(ARRIVALS) + ["trace"])
    ap.add_argument("--trace", default=None,
                    help="file with one arrival timestamp per line")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="offered load, requests/s")
    ap.add_argument("--slo", type=float, default=10.0,
                    help="per-request deadline, seconds after arrival")
    ap.add_argument("--policy", default="shed",
                    choices=["shed", "degrade", "none"])
    ap.add_argument("--batch-window", type=float, default=0.0)
    ap.add_argument("--quantum", type=float, default=float("inf"),
                    help="round quantum, seconds of fleet work")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="device of the weights and every replica")
    ap.add_argument("--check-invariance", action="store_true",
                    help="re-serve a few requests on a reference replica "
                         "and require identical tokens")
    args = ap.parse_args(argv)
    if args.arrival == "trace" and not args.trace:
        ap.error("--arrival trace requires --trace FILE")
    if args.smoke:
        args.requests = min(args.requests, 16)
        args.gen = min(args.gen, 8)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    check_servable(cfg)               # before its weights are built
    device = torch.device(args.device)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
    replicas = []
    for part in args.replicas.split(","):
        name, thr = part.split(":")
        replicas.append(Replica(name, cfg, params, throttle=float(thr),
                                device=device))

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    if args.arrival == "trace":
        with open(args.trace) as f:
            arrivals = trace_arrivals([float(x) for x in f if x.strip()])
        arrivals = arrivals[:args.requests]
    else:
        arrivals = ARRIVALS[args.arrival](args.requests, args.rate, rng)
    reqs = make_requests(arrivals, args.slo, prompt_fn=lambda i: prompts[i])

    server = CoexecServer(replicas, ServerConfig(
        scheduler=args.scheduler, lws=args.lws, gen=args.gen,
        policy=args.policy, batch_window_s=args.batch_window,
        round_quantum_s=args.quantum))
    try:
        out = server.run(RequestQueue(reqs))
    finally:
        server.close()
    st = out.stats
    print(f"{len(reqs)} requests @ {args.rate:.0f}/s ({args.arrival}), "
          f"SLO {args.slo:.2f}s, scheduler={args.scheduler}")
    print(st.row())
    print(f"dispatch={st.dispatch} degraded={st.degraded} "
          f"duration={st.duration:.2f}s")

    if args.check_invariance:
        # replica assignment / packing must not change outputs: re-serve a
        # few full-generation requests on a fresh reference replica
        full = [r for r in out.requests
                if not r.shed and r.finish is not None
                and not r.degraded][:4]
        if not full:
            print("outputs replica-invariant: skipped (no full requests)")
            return 0
        ref = Replica("ref", cfg, params, device=device)
        batch = np.stack([r.prompt for r in full])
        want = ref.serve(batch, args.gen)
        got = np.stack([out.results[r.rid] for r in full])
        ok = np.array_equal(got, want)
        print(f"outputs replica-invariant: {ok}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
