#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's sizes, one card
    python3 chip_smoke.py --small    # small sizes: a quick build-and-run

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the seven CUDA kernels from ``src/repro_torch/csrc`` (timed as
   set-up; the compiler's register and spill lines are printed);
3. co-execute the paper's four kernel programs on ``[cuda:0, cpu]``
   through ``repro_torch.api.coexec``, with HGuidedOpt seeded from a
   one-packet probe on each group.  Every kernel's launch counter is set to
   0 just before each run and read just after; the card's group must have
   run packets, not died, and launched its kernel, and the output must
   match ``reference_output`` on the card (Mandelbrot exactly);
4. register binomial as a workload and re-offload sub-regions of it in ROI
   mode (pooled buffers, pipelined loop), with the same checks;
5. hold each kernel against its plain PyTorch version on the card, at the
   main path's largest packet on the card (or a band of it where the plain
   version is too slow), and time kernel, plain version and, for the
   blur, one ``F.conv2d`` with the 31x31 outer-product weight, each time
   beside its share of the kernel's bound; time each of the four also
   at the smallest packet the card ran, and log binomial's and nbody's
   kernels' and plain
   versions' errors from float64 (binomial on 256 options, nbody's
   accelerations on 256 targets, where the kernel must stay within its
   earlier error at the paper's size);
5a. co-execute the other six programs of the suite on ``[cuda:0, cpu]``
    as phase 3 does: ``gaussian2d`` (8192 x 8192) and ``mandelbrot2d``
    (14,336 px, 5,000 iterations) as 2-D NDRanges whose row panels launch
    the card's kernels on tiles, ``ray1``, ``ray2``, ``ray1_2d`` and
    ``ray2_2d`` at 4,096 px (plain PyTorch ops on both groups, rendered in
    bands of rows).  The card's group must run packets and not die, the
    2-D image programs' launch counters (set to 0 just before) must be
    above 0, and each output must match ``reference_output`` on the card:
    Mandelbrot exactly, the blur at rtol/atol 1e-5, ray at ``RAY_TOL``
    with no pixel flipped;
5b. the paper's offloading modes on ``gaussian2d`` and ``mandelbrot2d``:
    an lws-aligned sub-region with col0 != 0 (``ROI_TILES``) submitted
    ``OFFLOAD_REPS`` times in binary mode and as often warm in ROI mode
    (after ``register_workload``), interleaved; the median and spread of
    the binary total, the ROI time, ``phases.init_s`` and the card's busy
    time of each mode, and every output equal to the block of the full
    reference;
5c. a ``gaussian2d`` run journaled under a temporary directory, its
    journal cut to two packets and resumed in a fresh session: replayed
    plus executed work must cover the program, the gaps must launch the
    card's kernel, and the output must equal the reference;
5d. ``autotune`` on ``[cuda:0, cpu]`` with ``TUNE_SIZES`` (a cache in a
    temporary directory): the fitted rates per group, the host terms and
    the winner; a second call must run no micro-benchmark, and
    ``coexec(..., tuned=...)`` must give the reference output;
5e. time ``blur_rows`` and ``escape_counts`` at the offloading phase's
    ROI tiles, beside their bounds, plain versions and (the blur) one
    ``F.conv2d``: a ``roi_tile`` entry of each kernel's record, with the
    2-D path's launches (one record per kernel, as ``long_shape`` is);
6. serve llama3.2-1b at full width (``--small``: 2 of its 16 layers) in
   bfloat16 on ``cuda:0`` through ``repro_torch.serve.CoexecServer``: two
   replicas (throttles 1 and 2) share one copy of the weights, 16
   requests arrive at t=0 (prompt 256, 32 generated tokens, lws 4,
   ``hguided_deadline``, no shedding, SLO 600 s).  All must be served;
   the launch counters, set to 0 after a warm-up, must show one
   ``flash_attention`` launch per layer and prefill and one
   ``flash_decode`` launch per layer and decode step; a fresh replica
   must give the same tokens.  Prefill and decode-step times come from
   CUDA events, beside the least time to read the weights once;
7. card against host: the same weights in float32 (TF32 off), a batch of
   2 with a 64-token prompt and 4 teacher-forced decode steps on
   ``cuda:0`` (kernels) and on the CPU (plain versions); the logits must
   agree within 1e-3 of the largest logit;
8. hold ``flash_attention`` and ``flash_decode`` against their plain
   versions at the serving shapes, a long shape, a ragged S and head
   dims 80 and 128 (bfloat16 at 2e-2, float32 at rtol 1e-4 / atol 2e-5),
   and time kernel, plain version and ``scaled_dot_product_attention``
   (with the kernel/SDPA ratio) at the serving shapes, the long shapes
   and qwen3-32b's heads (D = 128); the profiler must see exactly one
   kernel on the device for one ``flash_decode`` call at the serving
   shape;
9. serve falcon-mamba-7b at full width (``--small``: 2 of its 64 layers)
   in bfloat16 with the set-up of phase 6.  All must be served; the launch
   counters, set to 0 after a warm-up, must show one ``selective_scan``
   launch per layer and prefill and none in a decode step (one recurrence
   step in plain ops); a fresh replica must give the same tokens.
   Prefill and decode-step times from CUDA events, beside the weight-read
   bound, and a profile of each;
10. card against host as phase 7, on the first 8 of its 64 layers (a cut
    of depth that bounds the host's memory and time; full width);
11. hold ``selective_scan`` against its plain version at the serving
    shape, a long shape and a ragged one with a carried state (rtol 1e-4 /
    atol 1e-5), and time kernel and plain version; no single PyTorch call
    computes this recurrence, so it has no library time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores and dense bfloat16
# tensor-core operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_OPS_S = 989e12

PAPER_SIZES = {
    "gaussian": dict(h=8192, w=8192),
    "binomial": dict(n_options=4194304),
    "mandelbrot": dict(px=14336, max_iter=5000),
    "nbody": dict(n_bodies=229376),
}
# kernel against plain version (and card against host packets):
# Mandelbrot exactly, the rest as the JAX package's kernel tests hold them
TOLERANCES = {"gaussian": (1e-5, 1e-5), "binomial": (1e-4, 1e-3),
              "nbody": (2e-4, 2e-4)}
# nbody at the paper's size: the largest relative error from float64 of
# the kernel's accelerations over 256 targets, that of the earlier kernel
# (rsqrt(r2) / r2 * m, one running sum per target) at these inputs
NBODY_F64_REL = 1.89e-6
SMALL_SIZES = {
    "gaussian": dict(h=1024, w=512),
    "binomial": dict(n_options=65536),
    "mandelbrot": dict(px=512, max_iter=256),
    "nbody": dict(n_bodies=8192),
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    """A phase's check; raises (never an assert, which -O removes)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, torch, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events around the whole run.  The card first spins for
    ~20 ms, so the host queues all ``reps`` calls before the first one
    runs and the events time the device's work, not the host's launch
    gaps between short kernels."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(35_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_S):
    """(least ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at ``ops_per_s`` (float32 by default) on the card."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def binomial_ops(n_options: int, steps: int) -> float:
    """Float32 operations of pricing ``n_options`` on a tree of ``steps``:
    2 a node-step of the induction, 6 a leaf and 12 for the prologue.  A
    node-step is at least one fused multiply-add (2 operations, as the peak
    counts it): taking K steps in one pass costs (2K + 1) / K a node-step,
    one step at a time 3."""
    return n_options * (2.0 * steps * (steps + 1) / 2 + 6.0 * (steps + 1)
                        + 12)


def fleet():
    from repro_torch.core.device import DeviceGroup
    return [DeviceGroup("cuda0", device="cuda:0"),
            DeviceGroup("cpu", device="cpu")]


def probe(prog, devices):
    """Computing power (dim-0 units/s) of each group from one packet in
    the middle of the range (a card: 1/16 of it after a warm-up; the
    host: one work-group), full-width row panels of a 2-D program."""
    G, lws = prog.total_work, prog.lws
    region = prog.work_region
    powers = []
    for d in devices:
        fn, d0 = prog.build(d), region.dims[0]
        if region.ndim == 2:
            d1 = region.dims[1]

            def call(offset, rows, fn=fn):
                return fn(d0.offset + offset, rows, d1.offset, d1.size)
        else:
            def call(offset, rows, fn=fn):
                return fn(d0.offset + offset, rows)
        size = max(lws, G // 16 // lws * lws) if d.is_cuda else lws
        off = (G // 2 - size // 2) // lws * lws
        if d.is_cuda:
            d.run_packet(call, off, size)
        _, wg_s = d.run_packet(call, off, size)
        powers.append(wg_s)
    return powers


def check_card_group(res, devices, name):
    gpu = devices[0]
    check(res.aborted_devices == 0, f"{name}: aborted devices")
    check(not gpu.dead, f"{name}: the card's group was marked dead")
    check(gpu.packets_done > 0, f"{name}: the card ran no packet")


# ------------------------------------------------------------ serving path
SERVE = dict(requests=16, prompt=256, gen=32, lws=4)
PARITY = dict(batch=2, prompt=64, steps=4)
# kernel against plain version: those of tests/test_kernels.py:120-124
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 2e-5)}
# the selective scan: that of tests/test_kernels.py:152
SCAN_TOL = (1e-4, 1e-5)
# falcon-mamba-7b's card-against-host check runs its first 8 layers
MAMBA_PARITY_LAYERS = 8


def profile_window(torch, fn, n: int):
    """Device time by kernel over ``n`` calls of ``fn``, from
    ``torch.profiler``; returns (device ms per call, top kernels) or None
    where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue          # host ops: their kernels are rows of their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / n / 1e3, e.key))
    if not rows:
        return None
    rows.sort(reverse=True)
    return sum(ms for ms, _ in rows), rows[:8]


def device_ops_per_call(torch, fn, n: int):
    """(device operations per call, their names) of ``n`` calls of
    ``fn``, from ``torch.profiler``: every kernel, copy and memset the
    calls put on the device."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a spin kernel on either side of the window, so that the trace's
        # first and last events are not the calls' own
        torch.cuda._sleep(100_000)
        for _ in range(n):
            fn()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    ops = [(e.key, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "spin_kernel" not in e.key]
    return sum(c for _, c in ops) / n, sorted(k for k, _ in ops)


def serve_model(torch, dev0, cfg, params, launches, per_prefill, per_step):
    """Serve ``SERVE`` through ``CoexecServer`` on two replicas sharing
    ``params``; check that all are served, that every kernel of the path
    launched ``per_prefill[name]`` times a prefill plus ``per_step[name]``
    times a decode step (and the others never), and that the tokens are
    replica-invariant; time a prefill and a decode step and profile
    both.  Records the path's launch counts in ``launches``."""
    from repro_torch.kernels.flash_attention import kernel as KA
    from repro_torch.kernels.flash_decode import kernel as KD
    from repro_torch.kernels.mamba_scan import kernel as KS
    from repro_torch.models import transformer as T
    from repro_torch.serve import (CoexecServer, Replica, RequestQueue,
                                   ServerConfig, make_requests)

    counters = {"flash_attention": KA, "flash_decode": KD,
                "selective_scan": KS}
    n_req, P, gen, lws = (SERVE[k] for k in ("requests", "prompt", "gen",
                                               "lws"))
    w_bytes = T.param_bytes(params)

    class CountingReplica(Replica):
        """Counts prefill calls and decode steps of ``serve``."""
        calls = steps = 0

        def serve(self, prompts, gen, cache_len=None):
            self.calls += 1
            self.steps += gen
            return super().serve(prompts, gen, cache_len)

    reps = [CountingReplica("r0", cfg, params, throttle=1.0, device=dev0),
            CountingReplica("r1", cfg, params, throttle=2.0, device=dev0)]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n_req, P)).astype(np.int32)
    # warm-up (first launches, library plans) outside the counted run
    for r in reps:
        r.serve(np.stack([prompts[0]] * lws), gen, P + gen)
        r.calls = r.steps = 0
    torch.cuda.synchronize()
    server = CoexecServer(reps, ServerConfig(
        scheduler="hguided_deadline", lws=lws, gen=gen, policy="none",
        warmup=False))
    reqs = make_requests([0.0] * n_req, slo=600.0,
                         prompt_fn=lambda i: prompts[i])
    for k in counters.values():
        k.launches = 0
    try:
        out = server.run(RequestQueue(reqs))
    finally:
        server.close()
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in counters.items()}
    calls = sum(r.calls for r in reps)
    steps = sum(r.steps for r in reps)
    for name in set(per_prefill) | set(per_step):
        launches[name] = counts[name]
    st = out.stats
    check(st.served == n_req, f"serve: {st.served} of {n_req} served")
    check(sum(st.dispatch.values()) == n_req,
          f"serve: dispatch counts {st.dispatch}")
    for name, n in counts.items():
        want = per_prefill.get(name, 0) * calls + per_step.get(name, 0) * steps
        check(n == want, f"serve: {n} {name} launches for {calls} prefills "
                         f"and {steps} decode steps of {cfg.n_layers} "
                         f"layers (expected {want})")
    toks = np.stack([out.results[r.rid] for r in out.requests])
    check(toks.shape == (n_req, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"serve: tokens of shape {toks.shape} out of range")
    log(f"serve: {st.row()} dispatch={st.dispatch} "
        f"duration={st.duration:.3f} s, decode {n_req * gen / st.duration:.1f}"
        f" tokens/s, {calls} prefills and {steps} decode steps, launches "
        + " ".join(f"{name} {n}" for name, n in counts.items()))
    # replica invariance: four requests again on a fresh replica
    # (one packet alone, its time against the server's shared-card rounds)
    first = out.requests[:4]
    t0 = time.perf_counter()
    want = Replica("ref", cfg, params, device=dev0).serve(
        np.stack([r.prompt for r in first]), gen)
    alone_s = time.perf_counter() - t0
    got = np.stack([out.results[r.rid] for r in first])
    check(np.array_equal(got, want), "serve: tokens not replica-invariant")
    log(f"serve: tokens replica-invariant on rids "
        f"{[r.rid for r in first]}; that packet alone on a fresh replica "
        f"took {alone_s:.3f} s")

    with torch.inference_mode():
        batch = torch.as_tensor(prompts[:lws], device=dev0)
        cache = T.init_cache(cfg, lws, P + gen, dev0)
        prefill_ms = cuda_ms(lambda: T.prefill(cfg, params, batch, cache),
                             torch, 5)
        tok = batch[:, :1]
        pos = P + gen // 2
        step_ms = cuda_ms(lambda: T.decode_step(cfg, params, tok, cache,
                                                pos), torch, 20)
        log(f"serve: prefill (batch {lws} x {P}) {prefill_ms:.3f} ms, "
            f"decode step (batch {lws}, pos {pos}) {step_ms:.3f} ms; "
            f"reading the weights once takes at least "
            f"{w_bytes / HBM_BYTES_S * 1e3:.3f} ms")
        for label, fn, ms_call in (
                ("prefill", lambda: T.prefill(cfg, params, batch, cache),
                 prefill_ms),
                ("decode step", lambda: T.decode_step(cfg, params, tok,
                                                      cache, pos), step_ms)):
            try:       # a diagnostic: the run goes on without a trace
                prof = profile_window(torch, fn, 3)
            except Exception as e:
                prof = None
                log(f"profile {label}: torch.profiler failed ({e!r})")
            if prof is None:
                log(f"profile {label}: no device time in the trace")
                continue
            dev_ms, top = prof
            log(f"profile {label}: {dev_ms:.3f} ms of kernels per call "
                f"against {ms_call:.3f} ms between CUDA events (busy "
                f"{dev_ms / ms_call:.1%}); "
                + "; ".join(f"{ms:.3f} ms {k[:60]}" for ms, k in top))
    del server, reps, cache, out
    torch.cuda.empty_cache()


def card_against_host(torch, dev0, cfg32, p32, label):
    """Teacher-forced ``PARITY`` in float32 (TF32 off) with ``p32`` on
    the card (kernels) and then on the host (plain versions); the logits
    must agree within 1e-3 of the largest.  Moves ``p32`` to the host."""
    from repro_torch.models import transformer as T

    B2, P2, n_steps = (PARITY[k] for k in ("batch", "prompt", "steps"))
    ptoks = np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B2, P2 + n_steps)).astype(np.int32)

    def teacher_forced(device):
        with torch.inference_mode():
            t = torch.as_tensor(ptoks, device=device)
            cache = T.init_cache(cfg32, B2, P2 + n_steps, device)
            lg, cache = T.prefill(cfg32, p32, t[:, :P2], cache)
            outs = [lg[:, 0]]
            for i in range(P2, P2 + n_steps):
                lg, cache = T.decode_step(cfg32, p32, t[:, i:i + 1], cache, i)
                outs.append(lg[:, 0])
            return torch.stack(outs, dim=1).cpu()

    t0 = time.perf_counter()
    card = teacher_forced(dev0)
    t_card = time.perf_counter() - t0
    p32.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = teacher_forced(torch.device("cpu"))
    t_host = time.perf_counter() - t0
    top = float(host.abs().max())
    err = float((card - host).abs().max())
    # float32 on both sides with TF32 off: what is left is the order of
    # summation (cuBLAS against the host BLAS, the kernels' tiles against
    # the plain versions' whole rows) over every layer
    tol = 1e-3 * top
    check(bool(torch.isfinite(card).all()) and card.shape == host.shape,
          "parity: logits not finite or of another shape")
    check(err <= tol, f"parity: max |card - host| {err:.3g} above "
                      f"{tol:.3g} (1e-3 of the largest logit {top:.3g})")
    log(f"parity {label} float32 (TF32 off), batch {B2}, prompt {P2}, "
        f"{n_steps} decode steps: max |card - host| {err:.3g} = "
        f"{err / top:.3g} of the largest logit {top:.3g} (limit 1e-3); "
        f"card {t_card:.2f} s, host {t_host:.2f} s")


def long_entry(r, label="long shape"):
    """A long shape's measurements, for its kernel's JSON record."""
    b_ms, b_by = bound(r["nbytes"], r["ops"], r["ops_per_s"])
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    log(f"  {label} {r['shape']}: {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library {lib}")
    return dict(shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=b_ms, bound_by=b_by,
                library_ms=r["library_ms"], max_abs_err=r["err"])


def make_params(torch, dev0, cfg):
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(dev0).manual_seed(0))
    torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_inner {cfg.d_inner}, "
        f"{cfg.dtype}; {T.param_bytes(params) / 1e9:.3f} GB of weights made "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    return params


def serving_phases(args, torch, dev0, launches, record):
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD

    F = torch.nn.functional
    cfg = get_config("llama3.2-1b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    P, gen, lws = (SERVE[k] for k in ("prompt", "gen", "lws"))

    # -------------------------------------------------- serve, full width
    params = make_params(torch, dev0, cfg)
    serve_model(torch, dev0, cfg, params, launches,
                per_prefill={"flash_attention": cfg.n_layers},
                per_step={"flash_decode": cfg.n_layers})

    # ------------------------------------------- card against host, f32
    p32 = copy.deepcopy(params).to(torch.float32)
    del params
    torch.cuda.empty_cache()
    card_against_host(torch, dev0, replace(cfg, dtype="float32"), p32,
                      cfg.name)
    del p32

    # --------------------------------- kernels against plain versions
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen_t = torch.Generator(dev0).manual_seed(2)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    def attn_check(B, S, h, kh, d, dtype, timed=False):
        q, k, v = (randn(s, dtype) for s in ((B, S, h, d), (B, S, kh, d),
                                             (B, S, kh, d)))
        got = KA.flash_attention(q, k, v)
        want = RA.attention_ref(q, k, v)
        rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = float((got.float() - want.float()).abs().max())
        shape = f"B={B} S={S} H={h} KH={kh} D={d} {dtype}"
        log(f"  flash_attention {shape}: max abs err {err:.3g}")
        if not timed:
            return None
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).float() - got.float()).abs()
                        .max())
        log(f"  sdpa vs kernel max abs diff {lib_err:.3g}")
        elt = q.element_size()
        res = dict(
            err=err, shape=shape,
            ms=cuda_ms(lambda: KA.flash_attention(q, k, v), torch),
            plain_ms=cuda_ms(lambda: RA.attention_ref(q, k, v), torch, 2),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), torch),
            nbytes=elt * (2 * B * S * h * d + 2 * B * S * kh * d),
            ops=4.0 * B * h * d * S * (S + 1) / 2,
            ops_per_s=BF16_OPS_S if dtype == torch.bfloat16 else FP32_OPS_S)
        log(f"  timed {shape}: kernel {res['ms']:.4f} ms, SDPA "
            f"{res['library_ms']:.4f} ms, kernel/SDPA "
            f"{res['ms'] / res['library_ms']:.3f}")
        del q, k, v, qt, kt, vt, got, want, lib
        torch.cuda.empty_cache()
        return res

    def decode_check(B, Smax, h, kh, d, pos, dtype, timed=False):
        q = randn((B, h, d), dtype)
        kc, vc = randn((B, Smax, kh, d), dtype), randn((B, Smax, kh, d), dtype)
        got = KD.flash_decode(q, kc, vc, pos)
        want = RD.decode_attention(q, kc, vc, pos)
        rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        err = float((got.float() - want.float()).abs().max())
        shape = f"B={B} Smax={Smax} pos={pos} H={h} KH={kh} D={d} {dtype}"
        log(f"  flash_decode {shape}: max abs err {err:.3g}")
        if not timed:
            return None
        ms = cuda_ms(lambda: KD.flash_decode(q, kc, vc, pos), torch)
        plain_ms = cuda_ms(lambda: RD.decode_attention(q, kc, vc, pos),
                           torch, 1)
        # the library yardstick attends over the live prefix, copied to
        # its (B, KH, L, D) layout outside the timed call
        qt = q[:, :, None]
        kt, vt = (c[:, :pos + 1].transpose(1, 2).contiguous()
                  for c in (kc, vc))
        lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        log(f"  sdpa vs kernel max abs diff "
            f"{float((lib[:, :, 0].float() - got.float()).abs().max()):.3g}")
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), torch)
        elt = q.element_size()
        res = dict(err=err, shape=shape, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   nbytes=elt * (2 * B * (pos + 1) * kh * d + 2 * B * h * d),
                   ops=4.0 * B * h * d * (pos + 1),
                   ops_per_s=BF16_OPS_S if dtype == torch.bfloat16
                   else FP32_OPS_S)
        log(f"  timed {shape}: kernel {ms:.4f} ms, SDPA {library_ms:.4f} "
            f"ms, kernel/SDPA {ms / library_ms:.3f}")
        del q, kc, vc, kt, vt, got, want, lib
        torch.cuda.empty_cache()
        return res

    bf16, f32 = torch.bfloat16, torch.float32
    log("kernels of the serving path against their plain versions:")
    serve_a = attn_check(lws, P, H, KH, D, bf16, timed=True)
    long_S = 1024 if args.small else 4096
    long_a = attn_check(2, long_S, H, KH, D, bf16, timed=True)
    # qwen3-32b's heads: D = 128 runs another instantiation of the kernel
    d128_a = attn_check(1, long_S, 64, 8, 128, bf16, timed=True)
    attn_check(2, 1000, H, KH, D, bf16)           # ragged S
    attn_check(1, 1000, H, KH, D, f32)
    attn_check(2, 256, 8, 4, 80, f32)             # stablelm-3b's head dim
    attn_check(2, 256, 8, 4, 80, bf16)
    attn_check(1, 384, 16, 2, 128, f32)           # qwen3-32b's head dim
    attn_check(1, 384, 16, 2, 128, bf16)
    serve_d = decode_check(lws, P + gen, H, KH, D, P + gen - 1, bf16,
                           timed=True)
    # one flash_decode call is one kernel on the device: no combine pass,
    # no memset of the split counters
    qd = randn((lws, H, D), bf16)
    kcd, vcd = (randn((lws, P + gen, KH, D), bf16) for _ in range(2))
    n_ops, names = device_ops_per_call(
        torch, lambda: KD.flash_decode(qd, kcd, vcd, P + gen - 1), 10)
    log(f"  flash_decode at the serving shape: {n_ops:g} device operations "
        f"a call ({names})")
    check(n_ops == 1, f"flash_decode: {n_ops} device operations a call, "
                      f"expected one kernel ({names})")
    del qd, kcd, vcd
    long_B, long_Smax = (16, 4096) if args.small else (128, 32768)
    long_d = decode_check(long_B, long_Smax, H, KH, D, long_Smax - 1, bf16,
                          timed=True)
    decode_check(3, 1000, H, KH, D, 700, f32)
    decode_check(2, 512, 8, 4, 80, 300, bf16)
    decode_check(2, 512, 16, 2, 128, 511, f32)

    for name, res, lng, more, src, replaces in (
            ("flash_attention", serve_a, long_a,
             {"d128_shape": long_entry(d128_a)},
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:69"),
            ("flash_decode", serve_d, long_d, {},
             "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:63")):
        record(name, src, replaces, res["err"], res["ms"], res["plain_ms"],
               res["nbytes"], res["ops"], res["library_ms"],
               res["shape"] + " (serving shape)", res["ops_per_s"],
               long_shape=long_entry(lng), **more)


def mamba_phases(args, torch, dev0, launches, record):
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS
    from repro_torch.models import transformer as T

    cfg = get_config("falcon-mamba-7b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    P, lws = SERVE["prompt"], SERVE["lws"]
    di, ds = cfg.d_inner, cfg.ssm.d_state

    # -------------------------------------------------- serve, full width
    params = make_params(torch, dev0, cfg)
    serve_model(torch, dev0, cfg, params, launches,
                per_prefill={"selective_scan": cfg.n_layers}, per_step={})

    # ----------------------- card against host, f32, first layers only
    n_par = min(MAMBA_PARITY_LAYERS, cfg.n_layers)
    head = T.LM(params.embed, list(params.layers[:n_par]),
                params.final_norm, params.lm_head)
    p32 = copy.deepcopy(head).to(torch.float32)
    del params, head
    torch.cuda.empty_cache()
    log(f"parity {cfg.name}: depth cut to the first {n_par} of "
        f"{cfg.n_layers} layers at full width (host memory and time)")
    card_against_host(torch, dev0,
                      replace(cfg, n_layers=n_par, dtype="float32"), p32,
                      f"{cfg.name} ({n_par} layers)")
    del p32

    # ------------------------------ selective scan against plain version
    gen_t = torch.Generator(dev0).manual_seed(3)

    def scan_check(B, S, d, s, with_h0=False, timed=False):
        # the inputs of tests/test_kernels.py: a in [0.5, 0.99)
        a = 0.5 + 0.49 * torch.rand((B, S, d, s), generator=gen_t,
                                    device=dev0)
        b = torch.randn((B, S, d, s), generator=gen_t, device=dev0) * 0.1
        C = torch.randn((B, S, s), generator=gen_t, device=dev0)
        h0 = (torch.randn((B, d, s), generator=gen_t, device=dev0)
              if with_h0 else None)
        y, h = KS.selective_scan(a, b, C, h0)
        yr, hr = RS.selective_scan(a, b, C, h0)
        rtol, atol = SCAN_TOL
        torch.testing.assert_close(y, yr, rtol=rtol, atol=atol)
        torch.testing.assert_close(h, hr, rtol=rtol, atol=atol)
        err = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
        shape = (f"B={B} S={S} di={d} ds={s} float32"
                 + (" h0" if with_h0 else ""))
        log(f"  selective_scan {shape}: max abs err {err:.3g}")
        res = None
        if timed:
            # each input read once, each output written once; a multiply-
            # add, a multiply and a share of the ds-lane sum per element
            res = dict(
                err=err, shape=shape,
                ms=cuda_ms(lambda: KS.selective_scan(a, b, C, h0), torch),
                plain_ms=cuda_ms(lambda: RS.selective_scan(a, b, C, h0),
                                 torch, 1),
                library_ms=None,
                nbytes=4.0 * (2 * B * S * d * s + B * S * s + B * S * d
                              + B * d * s * (2 if with_h0 else 1)),
                ops=float(B * S * d * (4 * s - 1)), ops_per_s=FP32_OPS_S)
        del a, b, C, h0, y, h, yr, hr
        torch.cuda.empty_cache()
        return res

    log("selective_scan against its plain version:")
    serve_s = scan_check(lws, P, di, ds, timed=True)
    long_s = scan_check(2, 1024 if args.small else 4096, di, ds, timed=True)
    scan_check(1, 1000, 1000, 8, with_h0=True)        # ragged, a state
    record("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
           "src/repro/kernels/mamba_scan/kernel.py:55", serve_s["err"],
           serve_s["ms"], serve_s["plain_ms"], serve_s["nbytes"],
           serve_s["ops"], None, serve_s["shape"] + " (serving prefill)",
           long_shape=long_entry(long_s),
           library_note="no single PyTorch call computes this recurrence")


# --------------------------------------------- program suite and modes
SUITE_SIZES = {
    "gaussian2d": dict(h=8192, w=8192),
    "mandelbrot2d": dict(px=14336, max_iter=5000),
    "ray1": dict(px=4096), "ray2": dict(px=4096),
    "ray1_2d": dict(px=4096), "ray2_2d": dict(px=4096),
}
SMALL_SUITE_SIZES = {
    "gaussian2d": dict(h=1024, w=512),
    "mandelbrot2d": dict(px=512, max_iter=256),
    "ray1": dict(px=256), "ray2": dict(px=256),
    "ray1_2d": dict(px=256), "ray2_2d": dict(px=256),
}
# the offloading modes' sub-regions, (rows, cols) at (row0, col0), all
# lws-aligned with col0 != 0.  Mandelbrot's straddles the main cardioid's
# edge and the period-2 bulb (x in [-0.964, -0.536), y in [-0.214,
# 0.214)): some of its pixels run all 5,000 iterations, so the host
# group's 8-row packet of it takes about a second, not minutes
ROI_TILES = {"gaussian2d": ((4096, 4000), (1024, 1056)),
             "mandelbrot2d": ((2048, 2048), (6144, 6144))}
SMALL_ROI_TILES = {"gaussian2d": ((512, 256), (256, 160)),
                   "mandelbrot2d": ((128, 128), (192, 192))}
OFFLOAD_REPS = 3
# the autotuner's programs: the host group's whole-program span takes
# about a second (span_grid times up to the whole program on each group)
TUNE_SIZES = {"gaussian2d": dict(h=4096, w=4096),
              "binomial": dict(n_options=8192)}
SMALL_TUNE_SIZES = {"gaussian2d": dict(h=512, w=512),
                    "binomial": dict(n_options=1024)}
TUNE_ROUNDS = 5
# ray, card against host packets and against the card's reference: a
# float tolerance, and no pixel may flip (hit against miss, lit against
# shadowed), which moves a channel by more than RAY_FLIP
RAY_TOL = (1e-5, 1e-4)
RAY_FLIP = 1e-2


def compare_output(name, out, ref):
    """``out`` against the card's reference: Mandelbrot exactly, the blur
    at rtol/atol 1e-5, ray at ``RAY_TOL`` with no pixel flipped.  Returns
    (max abs difference, flipped pixels)."""
    check(out.shape == ref.shape and bool(np.isfinite(out).all()),
          f"{name}: output of shape {out.shape}, not finite or not "
          f"{ref.shape}")
    diff = np.abs(out.astype(np.float64) - ref)
    flips = 0
    if name.startswith("mandelbrot"):
        check(int((diff > 0).sum()) == 0,
              f"{name}: {int((diff > 0).sum())} counts differ")
    elif name.startswith("ray"):
        flips = int((diff.reshape(-1, 3).max(-1) > RAY_FLIP).sum())
        check(flips == 0, f"{name}: {flips} pixels flipped")
        np.testing.assert_allclose(out, ref, rtol=RAY_TOL[0],
                                   atol=RAY_TOL[1], err_msg=name)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    return float(diff.max()), flips


def med_spread(xs):
    return (f"median {float(np.median(xs)):.4f} s (min {min(xs):.4f}, "
            f"max {max(xs):.4f})")


def suite_phases(args, torch, dev0, attach):
    """The whole program suite on ``[cuda:0, cpu]``, the paper's two
    offloading modes, a journaled run resumed, and the autotuner."""
    import tempfile

    from repro_torch.api import (EngineSession, OffloadMode, Region,
                                 RunJournal, coexec, resume_run)
    from repro_torch.core import programs as P
    from repro_torch.kernels.gaussian import kernel as KG, ops as gops
    from repro_torch.kernels.gaussian import ref as RG
    from repro_torch.kernels.mandelbrot import kernel as KM, ref as RM
    from repro_torch.tune import TuneCache, autotune

    sizes = SMALL_SUITE_SIZES if args.small else SUITE_SIZES
    counters = {"gaussian": KG, "mandelbrot": KM}
    uses = {"gaussian2d": "gaussian", "mandelbrot2d": "mandelbrot"}
    launches2d, powers_of, refs = {}, {}, {}

    # -------------------------------------------- the whole program suite
    for name, kw in sizes.items():
        t0 = time.perf_counter()
        prog = P.PROGRAMS[name](**kw)
        devices = fleet()
        powers = powers_of[name] = probe(prog, devices)
        setup_s = time.perf_counter() - t0
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = coexec(prog, devices, powers=powers)
        wall = time.perf_counter() - t0
        counts = {k: m.launches for k, m in counters.items()}
        check_card_group(res, devices, name)
        if name in uses:
            launches2d[uses[name]] = counts[uses[name]]
            check(counts[uses[name]] > 0,
                  f"{name}: the card's {uses[name]} kernel unused")
        ref = P.reference_output(name, device=dev0, **kw)
        err, flips = compare_output(name, res.output, ref)
        if name in uses:
            refs[name] = ref
        G = prog.total_work
        n_gpu = sum(1 for p in res.packets if p.device == 0)
        share = sum(p.size for p in res.packets if p.device == 0) / G
        log(f"suite {name} {kw}: set-up {setup_s:.2f} s, run {wall:.3f} s "
            f"wall, roi {res.total_time:.3f} s, powers "
            f"{[round(p, 1) for p in powers]} units/s, share cuda0/cpu "
            f"{share:.4f}/{1 - share:.4f}, packets {n_gpu}/"
            f"{len(res.packets) - n_gpu}, launches {counts}, busy s "
            f"cuda0/cpu {res.device_busy[0]:.3f}/{res.device_busy[1]:.3f}, "
            f"max |out - ref| {err:.3g}, flipped pixels {flips}")

    # ------------------------------- offloading modes: binary against ROI
    tiles = SMALL_ROI_TILES if args.small else ROI_TILES
    for name, ((rows, cols), (r0, c0)) in tiles.items():
        kw = sizes[name]
        prog = P.PROGRAMS[name](**kw)
        roi = Region.rect(rows, cols, lws=tuple(
            d.lws for d in prog.work_region.dims), offset=(r0, c0))
        want = refs[name][r0:r0 + rows, c0:c0 + cols]
        powers = powers_of[name]
        times = {"binary": [], "roi": [], "init": [], "roi_init": [],
                 "card_binary": [], "card_roi": [], "binary_roi": []}
        roi_fleet, bin_fleet = fleet(), fleet()
        with EngineSession(roi_fleet, name="roi") as roi_s, \
                EngineSession(bin_fleet, name="binary") as bin_s:
            t0 = time.perf_counter()
            roi_s.register_workload(prog)
            reg_s = time.perf_counter() - t0
            for rep in range(OFFLOAD_REPS):
                # interleaved, the order alternating each round
                order = ("binary", "roi") if rep % 2 == 0 else ("roi",
                                                                "binary")
                for mode in order:
                    counters[uses[name]].launches = 0
                    if mode == "roi":
                        res = roi_s.submit(prog, region=roi,
                                           mode=OffloadMode.ROI,
                                           powers=powers).result()
                        times["roi"].append(res.total_time)
                        times["roi_init"].append(res.phases.init_s)
                        times["card_roi"].append(res.device_busy[0])
                        devices = roi_fleet
                    else:
                        res = bin_s.submit(prog, region=roi,
                                           mode=OffloadMode.BINARY,
                                           powers=powers).result()
                        times["binary"].append(res.binary_time)
                        times["binary_roi"].append(res.total_time)
                        times["init"].append(res.phases.init_s)
                        times["card_binary"].append(res.device_busy[0])
                        devices = bin_fleet
                    n_launch = counters[uses[name]].launches
                    check_card_group(res, devices, f"{name} {mode}")
                    check(n_launch > 0, f"{name} {mode}: the card's kernel "
                                        f"unused")
                    compare_output(name, res.output, want)
        log(f"modes {name} region {rows}x{cols} at ({r0}, {c0}) of {kw}, "
            f"{OFFLOAD_REPS} each, interleaved: register_workload "
            f"{reg_s:.4f} s")
        log(f"  binary total (init + offload + teardown) "
            f"{med_spread(times['binary'])}; its roi "
            f"{med_spread(times['binary_roi'])}; init "
            f"{med_spread(times['init'])}; card busy "
            f"{med_spread(times['card_binary'])}")
        log(f"  roi {med_spread(times['roi'])}; init "
            f"{med_spread(times['roi_init'])}; card busy "
            f"{med_spread(times['card_roi'])}")
        gap = 1 - float(np.median(times["roi"])) / float(
            np.median(times["binary"]))
        log(f"  roi against binary: {gap:.1%} less time (medians)")

    # ------------------------------------------ a journaled run, resumed
    name = "gaussian2d"
    kw = sizes[name]
    prog = P.PROGRAMS[name](**kw)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_journal") as tmp:
        path = str(Path(tmp) / "run.journal")
        with EngineSession(fleet()) as session, RunJournal(path) as j:
            session.submit(prog, journal=j, powers=powers_of[name]).result()
        records = RunJournal.read(path)[prog.name]
        keep = min(2, len(records) - 1)
        trunc = RunJournal.truncate_packets(path, keep)
        devices = fleet()
        with EngineSession(devices) as session, RunJournal(trunc) as j2:
            KG.launches = 0
            t0 = time.perf_counter()
            rep = resume_run(session, prog, j2, prog.name,
                             powers=powers_of[name])
            wall = time.perf_counter() - t0
    G = prog.total_work
    check(rep.replayed_wg + rep.executed_wg == G,
          f"resume: replayed {rep.replayed_wg} + executed "
          f"{rep.executed_wg} != {G}")
    check(rep.executed_wg > 0 and KG.launches > 0,
          "resume: no gap re-executed on the card")
    err, _ = compare_output(name, rep.output, refs[name])
    log(f"resume {name}: journal of {len(records)} packets cut to {keep}; "
        f"replayed {rep.replayed_wg} + executed {rep.executed_wg} of {G} "
        f"rows in gaps {rep.gaps}, {wall:.3f} s, launches {KG.launches}, "
        f"max |out - ref| {err:.3g}")

    # ---------------------------------------------------- the autotuner
    tsizes = SMALL_TUNE_SIZES if args.small else TUNE_SIZES
    programs = {k: P.PROGRAMS[k](**kw) for k, kw in tsizes.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune") as tmp:
        devices = fleet()
        t0 = time.perf_counter()
        report = autotune(devices, programs, "gaussian2d",
                          cache=TuneCache(str(Path(tmp) / "cache.json")),
                          rounds=TUNE_ROUNDS)
        tune_s = time.perf_counter() - t0
        cal = TuneCache(str(Path(tmp) / "cache.json")).get_calibration(
            report.fingerprint)
        check(report.microbenches_run > 0, "autotune: nothing measured")
        again = autotune(devices, programs, "gaussian2d",
                         cache=TuneCache(str(Path(tmp) / "cache.json")),
                         rounds=TUNE_ROUNDS)
        check(again.microbenches_run == 0 and again.cache_hit_winner,
              f"autotune: {again.microbenches_run} micro-benchmarks on a "
              f"warm cache")
    for k, per_dev in cal.kernels.items():
        rates = {d: f"{c.throughput:.1f} units/s + {c.overhead_s * 1e3:.3f}"
                    f" ms" for d, c in per_dev.items()}
        log(f"autotune {k} {tsizes[k]}: fitted {rates}")
    cfg = report.config
    log(f"autotune: {report.microbenches_run} timed runs in {tune_s:.2f} s; "
        f"lock crossing {cal.sched_overhead_s * 1e6:.2f} us, wake "
        f"{cal.wake_cost_s * 1e6:.2f} us, copy {cal.transfer_base_s * 1e6:.2f}"
        f" us + {cal.transfer_s_per_byte * 1e12:.2f} ps/B, crossover "
        f"{cfg.async_threshold_bytes} B; winner {cfg.scheduler} "
        f"{cfg.scheduler_kwargs} lws {cfg.lws}, lease "
        f"{cfg.lease_params()}, predicted {cfg.predicted_s:.4f} s against "
        f"the default's {cfg.predicted_default_s:.4f} s; the second call "
        f"ran {again.microbenches_run} micro-benchmarks")
    prog = programs["gaussian2d"]
    devices = fleet()
    KG.launches = 0
    res = coexec(prog, devices, tuned=cfg)
    check_card_group(res, devices, "tuned gaussian2d")
    err, _ = compare_output("gaussian2d", res.output, P.reference_output(
        "gaussian2d", device=dev0, **tsizes["gaussian2d"]))
    n_gpu = sum(1 for p in res.packets if p.device == 0)
    log(f"tuned coexec gaussian2d {tsizes['gaussian2d']}: roi "
        f"{res.total_time:.3f} s, packets {n_gpu}/{len(res.packets) - n_gpu},"
        f" launches {KG.launches}, max |out - ref| {err:.3g}")

    # ---------------------- the two kernels at the offloading ROI tiles
    (rows, cols), (r0, c0) = tiles["gaussian2d"]
    img = np.random.default_rng(0).standard_normal(
        (sizes["gaussian2d"]["h"], sizes["gaussian2d"]["w"])).astype(
        np.float32)
    ip, wts = gops.prepare(img)
    ipd, wd = torch.from_numpy(ip).to(dev0), torch.from_numpy(wts).to(dev0)
    K = wts.shape[0]
    window = ipd[:, c0:c0 + cols + K - 1]
    got = gops.run_region(ipd, wd, r0, rows, c0, cols)
    want = RG.blur_rows_ref(window, wd, r0, rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    band = window[r0:r0 + rows + K - 1][None, None]
    w2 = (wd[:, None] * wd[None, :])[None, None]
    attach("gaussian", roi_tile=dict(long_entry(dict(
        err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: KG.blur_rows(ipd, wd, r0, rows, c0, cols), torch),
        plain_ms=cuda_ms(lambda: RG.blur_rows_ref(window, wd, r0, rows),
                         torch, 2),
        nbytes=4.0 * ((rows + K - 1) * (cols + K - 1) + rows * cols + K),
        ops=2.0 * K * rows * ((cols + K - 1) + cols), ops_per_s=FP32_OPS_S,
        library_ms=cuda_ms(lambda: torch.nn.functional.conv2d(band, w2),
                           torch),
        shape=f"ROI tile rows [{r0}, {r0 + rows}) x cols [{c0}, "
              f"{c0 + cols}) of the padded {ip.shape} image (2-D path)"),
        "gaussian"),
        launches=launches2d["gaussian"]))
    del ipd, wd, window, band, got, want
    (rows, cols), (r0, c0) = tiles["mandelbrot2d"]
    px, iters = sizes["mandelbrot2d"]["px"], sizes["mandelbrot2d"]["max_iter"]
    got = KM.escape_counts(r0, rows, px, px, iters, c0, cols, device=dev0)
    want = RM.escape_counts(r0, rows, px, px, iters, c0, cols, device=dev0)
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"mandelbrot ROI tile: {n_bad} counts differ")
    iters_done = float(got.sum())
    attach("mandelbrot", roi_tile=dict(long_entry(dict(
        err=0.0,
        ms=cuda_ms(lambda: KM.escape_counts(r0, rows, px, px, iters, c0,
                                            cols, device=dev0), torch),
        plain_ms=cuda_ms(lambda: RM.escape_counts(r0, rows, px, px, iters,
                                                  c0, cols, device=dev0),
                         torch, 1),
        nbytes=4.0 * rows * cols,
        ops=8.0 * iters_done + 6.0 * rows * cols, ops_per_s=FP32_OPS_S,
        library_ms=None,
        shape=f"ROI tile rows [{r0}, {r0 + rows}) x cols [{c0}, "
              f"{c0 + cols}) of {px} px, {iters_done:.0f} iterations "
              f"(2-D path)"), "mandelbrot"),
        launches=launches2d["mandelbrot"]))
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small sizes instead of the paper's")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.api import EngineSession, OffloadMode, Region, coexec
        from repro_torch.core import programs as P
        from repro_torch.kernels import build
        from repro_torch.kernels.binomial import kernel as KB, ref as RB
        from repro_torch.kernels.gaussian import kernel as KG, ref as RG
        from repro_torch.kernels.mandelbrot import kernel as KM, ref as RM
        from repro_torch.kernels.nbody import kernel as KN, ref as RN
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"the port imported {leaked}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev0 = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------- build
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {build.build_seconds:.2f} s)")
    for src, rep in sorted(build.ptxas_report.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    sizes = SMALL_SIZES if args.small else PAPER_SIZES
    kernels = {"gaussian": KG, "binomial": KB, "mandelbrot": KM,
               "nbody": KN}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def check_group(res, devices, name, used):
        check_card_group(res, devices, name)
        for k in used:
            check(kernels[k].launches > 0, f"{name}: {k} kernel unused")

    # ----------------------------------------------------- main path
    launches, largest, smallest = {}, {}, {}
    outputs = {}
    for name, kw in sizes.items():
        t0 = time.perf_counter()
        prog = P.PROGRAMS[name](**kw)
        devices = fleet()
        powers = probe(prog, devices)
        setup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        res = coexec(prog, devices, powers=powers)
        wall = time.perf_counter() - t0
        counts = {k: m.launches for k, m in kernels.items()}
        check_group(res, devices, name, [name])
        launches[name] = counts[name]
        G = prog.total_work
        share = [sum(p.size for p in res.packets if p.device == i) / G
                 for i in range(len(devices))]
        gpu_pkts = [p for p in res.packets if p.device == 0]
        big = max(gpu_pkts, key=lambda p: p.size)
        largest[name] = (big.offset, big.size)
        small = min(gpu_pkts, key=lambda p: p.size)
        smallest[name] = (small.offset, small.size)
        ref = P.reference_output(name, device=dev0, **kw)
        out = res.output
        check(out.shape == ref.shape and bool(np.isfinite(out).all()),
              f"{name}: output of shape {out.shape}, not finite or not "
              f"{ref.shape}")
        if name == "mandelbrot":
            n_bad = int((out != ref).sum())
            check(n_bad == 0, f"mandelbrot: {n_bad} counts differ")
        else:
            rtol, atol = TOLERANCES[name]
            np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol,
                                       err_msg=name)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        if name == "binomial":
            outputs[name] = ref
        log(f"coexec {name} {kw}: set-up {setup_s:.2f} s, run "
            f"{wall:.3f} s wall, roi {res.total_time:.3f} s, powers "
            f"{[round(p, 1) for p in powers]} wg/s, share cuda0/cpu "
            f"{share[0]:.4f}/{share[1]:.4f}, packets "
            f"{len(gpu_pkts)}/{len(res.packets) - len(gpu_pkts)}, "
            f"launches {counts}, busy s cuda0/cpu "
            f"{res.device_busy[0]:.3f}/{res.device_busy[1]:.3f}, "
            f"max |out - ref| {err:.3g}")

    # ------------------------------------------------ ROI re-offload
    kw = sizes["binomial"]
    prog = P.PROGRAMS["binomial"](**kw)
    devices = fleet()
    powers = probe(prog, devices)
    G = prog.total_work
    with EngineSession(devices) as session:
        session.register_workload(prog)
        for off, size in ((G // 2, G // 4), (G // 8, G // 4)):
            reset_counts()
            roi = Region.line(size, offset=off)
            res = session.submit(prog, region=roi, mode=OffloadMode.ROI,
                                 powers=powers).result()
            n_launch = KB.launches
            check_group(res, devices, "binomial ROI", ["binomial"])
            want = outputs["binomial"][off * 128:(off + size) * 128]
            np.testing.assert_allclose(res.output, want, rtol=1e-4,
                                       atol=1e-3)
            log(f"ROI binomial [{off}, {off + size}) of {G}: roi "
                f"{res.total_time:.3f} s, init {res.phases.init_s:.4f} s, "
                f"launches {n_launch}")

    # ---------------------------------- kernels against plain versions
    records = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, ops,
               library_ms, shape, ops_per_s=FP32_OPS_S, n_launches=None,
               **extra):
        b_ms, b_by = bound(nbytes, ops, ops_per_s)
        n = launches[name] if n_launches is None else n_launches
        rec = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=n, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, shape=shape, **extra)
        records.append(rec)
        log(f"kernel {name} {shape}: {ms:.4f} ms ({b_ms / ms:.1%} of its "
            f"bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}),"
            f" library {library_ms}, max abs err {err:.3g}")

    def attach(name, **extra):
        """Add entries (another shape's timings) to a kernel's record."""
        next(r for r in records if r["name"] == name).update(extra)

    def time_smallest(name, ms, nbytes, ops, what):
        """Log a kernel's time at the smallest packet the card ran in the
        ``coexec`` run, beside its bound (not part of the JSON record)."""
        b_ms, b_by = bound(nbytes, ops)
        log(f"  {name} at the smallest packet on the card ({what}): "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} "
            f"of its bound")

    # gaussian: the largest packet on the card, whole
    kw = sizes["gaussian"]
    rng = np.random.default_rng(0)
    img = rng.standard_normal((kw["h"], kw["w"])).astype(np.float32)
    from repro_torch.kernels.gaussian import ops as gops
    ip, wts = gops.prepare(img)
    ipd, wd = torch.from_numpy(ip).to(dev0), torch.from_numpy(wts).to(dev0)
    off, size = largest["gaussian"]
    r0, nr = off * gops.LWS, size * gops.LWS
    got = KG.blur_rows(ipd, wd, r0, nr)
    want = RG.blur_rows_ref(ipd, wd, r0, nr)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["gaussian"][0],
                               atol=TOLERANCES["gaussian"][1])
    err = float((got - want).abs().max())
    K = wts.shape[0]
    band = ipd[r0:r0 + nr + K - 1][None, None]
    w2 = (wd[:, None] * wd[None, :])[None, None]
    lib_out = torch.nn.functional.conv2d(band, w2)[0, 0]
    log(f"  conv2d vs kernel max abs diff "
        f"{float((lib_out - got).abs().max()):.3g}")
    Wp = ip.shape[1]
    W = Wp - (K - 1)
    record("gaussian", "src/repro_torch/csrc/gaussian.cu",
           "src/repro/kernels/gaussian/kernel.py:36", err,
           cuda_ms(lambda: KG.blur_rows(ipd, wd, r0, nr), torch),
           cuda_ms(lambda: RG.blur_rows_ref(ipd, wd, r0, nr), torch, 2),
           4.0 * ((nr + K - 1) * Wp + nr * W + K),
           2.0 * K * nr * (Wp + W),
           cuda_ms(lambda: torch.nn.functional.conv2d(band, w2), torch),
           f"rows {nr} of the padded {ip.shape} image (largest packet)")
    off, size = smallest["gaussian"]
    r0s, nrs = off * gops.LWS, size * gops.LWS
    torch.testing.assert_close(KG.blur_rows(ipd, wd, r0s, nrs),
                               RG.blur_rows_ref(ipd, wd, r0s, nrs),
                               rtol=TOLERANCES["gaussian"][0],
                               atol=TOLERANCES["gaussian"][1])
    time_smallest("gaussian",
                  cuda_ms(lambda: KG.blur_rows(ipd, wd, r0s, nrs), torch),
                  4.0 * ((nrs + K - 1) * Wp + nrs * W + K),
                  2.0 * K * nrs * (Wp + W), f"{nrs} rows")
    del ipd, band, got, want, lib_out

    # binomial: the largest packet on the card (at most 2**21 options:
    # the plain version holds several (n, 255) planes)
    from repro_torch.kernels.binomial import ops as bops
    s0, k0, ty = (torch.from_numpy(x).to(dev0)
                  for x in bops.make_inputs(sizes["binomial"]["n_options"]))
    off, size = largest["binomial"]
    a = off * bops.LWS
    n = min(size * bops.LWS, 1 << 21)
    args_b = (s0[a:a + n], k0[a:a + n], ty[a:a + n])
    got = KB.price_options(*args_b)
    want = RB.price_options(*args_b)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["binomial"][0],
                               atol=TOLERANCES["binomial"][1])
    steps = RB.STEPS
    record("binomial", "src/repro_torch/csrc/binomial.cu",
           "src/repro/kernels/binomial/kernel.py:42",
           float((got - want).abs().max()),
           cuda_ms(lambda: KB.price_options(*args_b), torch),
           cuda_ms(lambda: RB.price_options(*args_b), torch, 2),
           16.0 * n, binomial_ops(n, steps), None,
           f"{n} options of the largest packet ({size * bops.LWS})")
    # the kernel folds disc into its coefficients (one rounding fewer per
    # step than the plain version): both against float64 on 256 options
    sub = tuple(x[:256] for x in args_b)
    v64 = RB.price_options(*(x.double() for x in sub))
    worth = v64 >= 0.01
    for label, v in (("kernel", got[:256]), ("plain", want[:256])):
        e64 = (v.double() - v64).abs()
        log(f"  binomial |v - v_f64| over 256 options: {label} max "
            f"{float(e64.max()):.3g}, max relative (the "
            f"{int(worth.sum())} worth at least 0.01) "
            f"{float((e64[worth] / v64[worth]).max()):.3g}")
    off, size = smallest["binomial"]
    a_s, n_s = off * bops.LWS, size * bops.LWS
    args_s = tuple(x[a_s:a_s + n_s] for x in (s0, k0, ty))
    torch.testing.assert_close(KB.price_options(*args_s),
                               RB.price_options(*args_s),
                               rtol=TOLERANCES["binomial"][0],
                               atol=TOLERANCES["binomial"][1])
    time_smallest("binomial",
                  cuda_ms(lambda: KB.price_options(*args_s), torch),
                  16.0 * n_s, binomial_ops(n_s, steps), f"{n_s} options")
    del s0, k0, ty

    # mandelbrot: a 64-row band of the largest packet, nearest the centre
    kw = sizes["mandelbrot"]
    px, iters = kw["px"], kw["max_iter"]
    from repro_torch.kernels.mandelbrot import ops as mops
    off, size = largest["mandelbrot"]
    lo, hi = off * mops.LWS, (off + size) * mops.LWS
    nr = min(64, hi - lo)
    r0 = min(max(px // 2 - nr // 2, lo), hi - nr)
    got = KM.escape_counts(r0, nr, px, px, iters, device=dev0)
    want = RM.escape_counts(r0, nr, px, px, iters, device=dev0)
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"mandelbrot kernel: {n_bad} counts differ")
    iters_done = float(got.sum())
    record("mandelbrot", "src/repro_torch/csrc/mandelbrot.cu",
           "src/repro/kernels/mandelbrot/kernel.py:49", 0.0,
           cuda_ms(lambda: KM.escape_counts(r0, nr, px, px, iters,
                                            device=dev0), torch),
           cuda_ms(lambda: RM.escape_counts(r0, nr, px, px, iters,
                                            device=dev0), torch, 1),
           4.0 * nr * px, 8.0 * iters_done + 6.0 * nr * px, None,
           f"rows [{r0}, {r0 + nr}) x {px} of the largest packet "
           f"(rows [{lo}, {hi})), {iters_done:.0f} iterations")
    off, size = smallest["mandelbrot"]
    r0s, nrs = off * mops.LWS, size * mops.LWS
    got = KM.escape_counts(r0s, nrs, px, px, iters, device=dev0)
    nb = min(nrs, 64)     # the plain version on a band of it, as above
    n_bad = int((got[:nb] != RM.escape_counts(r0s, nb, px, px, iters,
                                              device=dev0)).sum())
    check(n_bad == 0, f"mandelbrot kernel: {n_bad} counts differ at the "
                      f"smallest packet")
    iters_s = float(got.sum())
    time_smallest("mandelbrot",
                  cuda_ms(lambda: KM.escape_counts(r0s, nrs, px, px, iters,
                                                   device=dev0), torch),
                  4.0 * nrs * px, 8.0 * iters_s + 6.0 * nrs * px,
                  f"rows [{r0s}, {r0s + nrs}) x {px}, {iters_s:.0f} "
                  f"iterations")

    # nbody: the largest packet on the card (at most 2**17 targets),
    # against all sources
    from repro_torch.kernels.nbody import ops as nops
    pm_np, vel_np = nops.make_inputs(sizes["nbody"]["n_bodies"])
    pm = torch.from_numpy(pm_np).to(dev0)
    vel = torch.from_numpy(vel_np).to(dev0)
    N = pm.shape[0]
    off, size = largest["nbody"]
    t0n = off * nops.LWS
    nt = min(size * nops.LWS, 1 << 17)
    got = KN.step_rows(pm, vel, t0n, nt)
    want = RN.step_rows(pm, vel, t0n, nt)
    torch.testing.assert_close(got, want, rtol=TOLERANCES["nbody"][0],
                               atol=TOLERANCES["nbody"][1])
    # the sum over N sources runs in another order in the kernel (one
    # running sum per target) than in the plain version (torch's
    # reduction): measure both against float64 on a subset of targets
    sub = slice(0, min(nt, 256))
    pm64 = pm.double()
    acc64 = RN.accelerations(pm64, t0n, sub.stop)     # pow(-1.5) form
    v0 = vel[t0n:t0n + sub.stop].double()
    rel = {}
    for label, rows in (("kernel", got), ("plain", want)):
        acc = (rows[sub, 4:7].double() - v0) / RN.DT
        rel[label] = float(((acc - acc64).norm(dim=1)
                            / acc64.norm(dim=1)).max())
    log(f"  nbody |acc - acc_f64| / |acc_f64| over {sub.stop} targets: "
        f"kernel {rel['kernel']:.3g}, plain {rel['plain']:.3g}")
    if not args.small:
        check(rel["kernel"] <= NBODY_F64_REL,
              f"nbody kernel: {rel['kernel']:.3g} from float64, above "
              f"{NBODY_F64_REL}")

    def nbody_bytes_ops(n_t):
        return 16.0 * N + 40.0 * n_t, 20.0 * n_t * N + 15.0 * n_t

    record("nbody", "src/repro_torch/csrc/nbody.cu",
           "src/repro/kernels/nbody/kernel.py:38",
           float((got - want).abs().max()),
           cuda_ms(lambda: KN.step_rows(pm, vel, t0n, nt), torch),
           cuda_ms(lambda: RN.step_rows(pm, vel, t0n, nt), torch, 2),
           *nbody_bytes_ops(nt), None,
           f"{nt} targets of the largest packet ({size * nops.LWS}) x "
           f"{N} sources")
    off, size = smallest["nbody"]
    t0s, nts = off * nops.LWS, size * nops.LWS
    torch.testing.assert_close(KN.step_rows(pm, vel, t0s, nts),
                               RN.step_rows(pm, vel, t0s, nts),
                               rtol=TOLERANCES["nbody"][0],
                               atol=TOLERANCES["nbody"][1])
    time_smallest("nbody",
                  cuda_ms(lambda: KN.step_rows(pm, vel, t0s, nts), torch),
                  *nbody_bytes_ops(nts), f"{nts} targets x {N} sources")

    suite_phases(args, torch, dev0, attach)
    serving_phases(args, torch, dev0, launches, record)
    mamba_phases(args, torch, dev0, launches, record)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"the port imported {leaked}")

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
