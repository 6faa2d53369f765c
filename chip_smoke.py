#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                # the paper's sizes, one card
    python3 chip_smoke.py --small        # small sizes: a quick build-and-run
    python3 chip_smoke.py --phase fleet  # the build and phase 8a alone

The whole script took 440-561 s of command time on one H100 before phase
8a, which adds about 40 s; ``--phase fleet`` builds the kernels and runs
phase 8a alone, prints no kernels line, and takes about a minute.

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the nine CUDA kernels from ``src/repro_torch/csrc`` (timed as
   set-up; the compiler's register and spill lines are printed) and the
   host routines of ``src/repro_torch/csrc/host`` with ``g++``;
3. co-execute the paper's four kernel programs on ``[cuda:0, cpu]``
   through ``repro_torch.api.coexec``, with HGuidedOpt seeded from a
   one-packet probe on each group.  Every kernel's launch counter and
   host-routine counter is set to 0 just before each run and read just
   after; the card's group must have run packets, not died, and launched
   its kernel, the host group's routine must have run once for each of its
   packets, and the output must match ``reference_output`` on the card
   (Mandelbrot exactly);
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
    bands of rows; the host group runs the compiled host routines).  The
    card's group must run packets and not die, the 2-D image programs'
    launch counters (set to 0 just before) must be above 0, the host
    routine must have run once for each host packet, and each output must
    match ``reference_output`` on the card:
    Mandelbrot exactly, the blur at rtol/atol 1e-5, ray at ``RAY_TOL``
    with no pixel flipped;
5b. the paper's offloading modes on ``gaussian2d`` and ``mandelbrot2d``:
    an lws-aligned sub-region with col0 != 0 (``ROI_TILES``) submitted
    ``OFFLOAD_REPS`` times in binary mode and as often warm in ROI mode
    (after ``register_workload``), interleaved; the median and spread of
    the binary total, the ROI time, ``phases.init_s`` and the card's busy
    time of each mode, every output equal to the block of the full
    reference, and the host routine run for each host packet;
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
5f. log the host CPU (``lscpu``), torch's thread count and the host
    library's build time; hold each host routine (Mandelbrot, the blur,
    binomial, nbody, ray) against its plain version on the host at the
    host group's largest packet of phases 3 and 5a (``HOST_CHECK_WG``
    work-groups of it; Mandelbrot exactly, ray at ``RAY_TOL`` with no
    pixel flipped, the rest at ``TOLERANCES``), time both, log nbody's
    host error from float64 on 256 targets, and give each routine a
    ``host`` entry: in its kernel's JSON record, ray's (it has no card
    kernel) under the line's ``host`` key with the host CPU;
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
   and qwen3-32b's heads (D = 128), the forward also keeping each row's
   log-sum-exp as training runs it; the profiler must see exactly one
   kernel on the device for one ``flash_decode`` call at the serving
   shape (a trace that lacks the spin kernels around its window has
   lost events and is taken again, up to 3 times);
8a. the fleet tier: llama3.2-1b at full width (``--small``: 2 of its 16
    layers) in bfloat16, random weights from seed 0, served through
    ``repro_torch.fleet.FleetServer`` by three ``ReplicaWorker``s whose
    replicas share one copy of the weights on ``cuda:0``: ``w0``
    (throttle 1, declared 4 requests/s), ``w1`` (throttle 2, 2/s) and
    ``spare`` (throttle 1, 4/s), the autoscaler's standby; each worker a
    ``CoexecServer`` (``hguided_deadline``, lws 4, 32 tokens, no
    shedding at the worker), the router ``deadline`` placement with
    ``shed`` admission, ``ElasticAutoscaler`` with ``FLEET_SCALE``'s
    times (sized by the card's rounds) and at most 3 workers.  48
    requests (``--small``: 16), prompt 256, SLO 600 s: 32 (12) at t=0,
    16 (4) by a Poisson process at 2/s (seed 0) after them.  Each replica
    is warmed up and the counters set to 0 before ``FleetServer.run``.
    All must be served and none shed; dispatch namespaced by worker and
    summing to the requests; at least one scale-up of ``spare``, which
    must serve; every session group on ``cuda:0`` at the start, before
    and after each scale event and after the run; exactly one
    ``flash_attention`` launch per layer and prefill and one
    ``flash_decode`` launch per layer and decode step, and no other; the
    first 4 requests of each worker equal on a fresh replica.  Logs the
    served time, tokens/s, p50/p99, SLO attainment, requests per worker,
    each group's times, a batch's time in the fleet against alone (the
    GIL and the card shared by three workers' threads), the scale
    events, the router's predicted finish against the measured, peak
    memory, and ``simulate_fleet`` on the same requests at the measured
    per-worker powers beside the measured attainment and p99;
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
    computes this recurrence, so it has no library time;
12. train llama3.2-1b at full width (``--small``: 2 of its 16 layers) in
    bfloat16 through ``HeteroDPTrainer``: two groups on ``cuda:0``
    (throttles 1 and 2) sharing one copy of the weights, random weights
    from seed 0, ``SyntheticPipeline`` (seed 1234) at TRAIN_4K's 4,096
    tokens, a global batch of 8 (TRAIN_4K's 256 cut to 8), lws 1, AdamW
    (lr 1e-3, warm-up 1, 8 total steps), 6 steps.  Every loss finite,
    8 x 4,096 tokens a step, the last loss below the first, rows on both
    groups; the launch counters, set to 0 before each step, must show 2 x
    16 ``flash_attention`` launches (forward and rematerialised recompute)
    and 16 ``flash_attention_bwd`` calls per packet.  Step time, tokens/s,
    balance, rows per group, peak memory and a profile of one more step;
    then ``launch.train`` in-process (2 steps, batch 4, accum 2) with
    finite losses and gradient norms;
13. card against host in float32 (TF32 off) on the first 2 layers at full
    width, batch 2 x 128: the loss within 1e-4 relative, every gradient
    within 1e-3 of its parameter's largest |g|, the parameters after one
    AdamW step within 1e-3 of their largest |value| (``TRAIN_FLIPS``);
    one ``HeteroDPTrainer`` step on ``[cuda:0, cpu]`` (batch 4, the host
    group running rows) against one on ``[cuda:0]`` alone from the same
    state and tokens, at the same tolerance; an ``AsyncCheckpointer`` save
    restored into a fresh state, whose next step's loss must equal the
    original's;
14. check that the bfloat16 backward's dK/dV and dQ kernels run on
    ``wgmma`` (HGMMA in their SASS, ``cuobjdump``); hold
    ``flash_attention_bwd``, fed the log-sum-exp that the forward keeps,
    against ``attention_bwd_ref`` at the training packet (B=1, S=4096,
    32/8 heads, D=64, bfloat16), a ragged S, head dims 80 and 128 in both
    dtypes and the wgmma kernels' edges (G = 1, 4, 6, 8; S = 2, 50, 127,
    129) in bfloat16 (max |err| within 2e-2 of each output's largest
    |value| in bfloat16, 1e-4 in float32), two calls bitwise equal and
    equal to a call that has the forward write the log-sum-exp again;
    time the backward alone, plain version and SDPA's backward
    (``torch.autograd.grad`` through one ``scaled_dot_product_attention``)
    at the training packet;
15. hold ``flash_attention`` at MLA's head dim 192 (deepseek-v2-lite-16b:
    128 nope + 64 rope columns, H = KH = 16) against its plain version at
    the MLA prefill shape (B=4, S=256), the long shape (B=1, S=4096;
    ``--small``: 1024), a ragged S and G = 2, bfloat16 at 2e-2 and
    float32 at rtol 1e-4 / atol 2e-5, and time kernel, plain version and
    SDPA at the prefill and the long shape (the ``flash_attention_d192``
    record);
16. serve deepseek-v2-lite-16b at full width (``--small``: 2 of its 27
    layers, the dense one and one MoE layer) in bfloat16 with the set-up
    of phase 6.  All must be served; the launch counters, set to 0 after
    a warm-up, must show one ``flash_attention`` launch per layer and
    prefill (MLA's expanded prefill at D = 192) and none of any kernel in
    a decode step (the absorbed decode runs plain products); a fresh
    replica must give the same tokens.  Prefill and decode-step times
    from CUDA events beside the weight-read bound (all 64 experts' weights:
    the capacity formulation runs every expert), a profile of each, peak
    memory and each replica group's busy time;
17. card against host as phase 7 on the first 3 of its 27 layers (the
    dense one and two MoE layers; a cut of depth that bounds the host's
    memory and time): the logits within 1e-3 of the largest, every token
    routed to the same experts on both sides, and the smallest margin
    between the k-th and (k+1)-th router probability logged;
18. hold ``flash_attention`` and ``flash_decode`` against their plain
    versions at jamba-v0.1-52b's heads (H = 32, KH = 8, D = 128, the
    serving shapes, timed: the ``jamba_shape`` entries); serve
    jamba-v0.1-52b at full width on 16 of its 32 layers (two periods of
    8: 52.11 GB of bfloat16 weights; ``--small``: one period of 4,
    ``attn_every`` 4 at offset 2, the smoke config's period) with the
    set-up of phase 6.  All must be served; the launch counters, set to 0
    after a warm-up, must show one ``flash_attention`` launch per
    attention layer (2) and one ``selective_scan`` launch per Mamba layer
    (14) a prefill, one ``flash_decode`` launch per attention layer and no
    scan a decode step; a fresh replica must give the same tokens.
    Prefill and decode-step times beside the weight-read bound (the
    capacity dispatch runs all 16 experts), a profile of each, peak
    memory and each replica group's busy time;
19. card against host as phase 17 on layers 0, 1, 4 and 5 of the served
    model (Mamba + MoE, Mamba + MLP, attention + MoE, Mamba + MLP) run as
    one period of 4 at full width, in float32 (about 27.5 GB on each
    side): the logits within 1e-3 of the largest, every token routed to
    the same experts on both sides, the smallest top-2 margin logged;
20. internvl2-1b at full width (``--small``: 2 of its 24 layers): hold
    both attention kernels at its G = 7 (14 query heads over 2, D = 64;
    the ``g7_shape`` entries, timed at the serving shapes) against their
    plain versions; serve it as phase 6 does, without patches, as the JAX
    package's server serves it (one ``flash_attention`` launch per layer
    a prefill, one ``flash_decode`` launch per layer a decode step); run
    a prefill of 256 patch embeddings and 256 tokens (batch 4) and 32
    greedy steps, with the same launch counts; card against host in
    float32 on all its layers with patches;
21. hold both attention kernels at musicgen-large's heads (H = KH = 32,
    D = 64; the ``musicgen_shape`` entries, timed at its shapes, and a
    ragged S in both dtypes) against their plain versions; run
    musicgen-large at full width (48 layers, ``--small``: 2) through
    ``prefill`` and ``decode_step``: batch 4, a 256-position prompt of 4
    codebooks, 32 greedy steps (argmax per codebook, (4, 1, 4) tokens a
    step), 48 ``flash_attention`` launches a prefill and 48
    ``flash_decode`` launches a step; prefill and decode-step times
    beside the weight-read bound, and a profile; card against host in
    float32 on its first 8 layers (logits (B, 1, 4, V)).

22. hold ``selective_scan_bwd``, fed the states the forward keeps,
    against ``selective_scan_bwd_ref`` at the training packet (B=1,
    S=4096, di=8192, ds=16; ``--small``: S=1024; timed: kernel, plain
    version, bound) and at its edges (S not a multiple of 16, S = 1, ds =
    8 and 32, di not a multiple of a CTA's channels, non-zero h0 and
    dhT), max |err| within 1e-4 of each output's largest |value| + 1e-5,
    two calls bitwise equal;
23. hold ``flash_attention_bwd`` at jamba's heads (32/8, D = 128; timed
    at S=4096 with SDPA's backward); train jamba-v0.1-52b at full width
    on 2 layers (attention + MoE, Mamba + MLP: 3.68 B parameters) in
    bfloat16 through ``HeteroDPTrainer`` with phase 12's set-up, a global
    batch of 4 x 2,048 tokens (TRAIN_4K's 4,096 ran out of the card's
    memory; ``--small``: 2 x 1,024), 4 steps: every loss finite, the
    objective on a held-out batch lower after the steps than before
    them (each step's loss is on its own tokens), rows on both groups,
    and per packet
    2 ``flash_attention``, 1 ``flash_attention_bwd``, 2 ``selective_scan``
    and 1 ``selective_scan_bwd`` launches (counters set to 0 before each
    step); step time, tokens/s, peak memory and a profile of one more
    step;
24. card against host in float32 (TF32 off) on those 2 layers, batch 1
    x 256: the loss within 1e-4 relative, every gradient within 1e-3 of
    its parameter's largest |g|, every token routed to the same experts
    on both sides and in the rematerialised recompute as in the forward
    (the smallest top-2 margin logged); falcon-mamba-7b on 8 of its 64
    layers (``--small``: 2), 2 ``make_train_step`` steps of batch 2 x
    4,096: finite losses and gradient norms, 2 scan and 1 backward
    launches a layer; card against host on its first 2 layers;
25. hold ``flash_attention_bwd`` at internvl2-1b's G = 7 (14/2, D = 64)
    and musicgen-large's 32/32 heads (D = 64), timed at S=4096 with SDPA's
    backward, and at ragged S in both dtypes; train internvl2-1b (24
    layers, 256 patches a row) and musicgen-large (8 of 48 layers, (B,
    S, 4) tokens; ``--small``: 2 layers each) 3 steps each through
    ``HeteroDPTrainer`` with the launch counts of phase 23 and finite
    losses; card against host in float32 on 2 layers of each (internvl2-
    1b with 256 patch positions, which the loss leaves out; musicgen's
    loss averaged over its codebooks).

Phases 8a and 18–25 add their launches to the records of
``flash_attention``, ``flash_attention_bwd``, ``flash_decode`` and
``selective_scan`` (``launches_by_path``); phase 22's record is ``selective_scan_bwd``,
whose launches are phases 23–25's.  The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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


def check_host_group(res, host_calls, name):
    """Every packet of the host group (device 1) ran its compiled host
    routine: ``host_calls``, set to 0 before the run, is at least their
    number (above 0 wherever the host ran a packet)."""
    n_cpu = sum(1 for p in res.packets if p.device == 1)
    check(host_calls >= n_cpu, f"{name}: the host group ran {n_cpu} "
                               f"packets but its routine {host_calls} times")


def host_run(res, kw, host_calls):
    """What phase 5f needs of a run: the host group's packets (dim-0
    offset and size, absolute for a 2-D program), its routine's calls and
    busy time, and the dim-0 units the card ran."""
    pkts = [(p.region.dims[0].offset, p.region.dims[0].size)
            if p.region is not None and p.region.ndim == 2
            else (p.offset, p.size) for p in res.packets if p.device == 1]
    return dict(kw=kw, packets=pkts, host_calls=host_calls,
                busy_s=res.device_busy[1], roi_s=res.total_time,
                card_units=sum(p.size for p in res.packets
                               if p.device == 0))


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


def device_ops_per_call(torch, fn, n: int, tries: int = 3):
    """(device operations per call, their names) of ``n`` calls of
    ``fn``, from ``torch.profiler``: every kernel, copy and memset the
    calls put on the device.  A trace that lacks one of the two spin
    kernels around the window has lost events (it may come back empty):
    it is taken again, up to ``tries`` times, and the last one counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a spin kernel on either side of the window, so that the
            # trace's first and last events are not the calls' own
            torch.cuda._sleep(100_000)
            for _ in range(n):
                fn()
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        events = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(c for k, c in events if "spin_kernel" in k)
        ops = [(k, c) for k, c in events if "spin_kernel" not in k]
        if spins == 2:
            break
        log(f"  profiler trace {attempt + 1} of {tries} holds {spins} of "
            f"the 2 spin kernels: it lost events")
    return sum(c for _, c in ops) / n, sorted(k for k, _ in ops)


def free_card(torch, dev0, what):
    """Collect what earlier phases left in reference cycles and return the
    cached blocks, then log what the card and the host still hold."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    avail = next((int(ln.split()[1]) * 1024 / 1e9
                  for ln in open("/proc/meminfo")
                  if ln.startswith("MemAvailable:")), float("nan"))
    log(f"{what}: {torch.cuda.memory_allocated(dev0) / 1e9:.2f} GB allocated "
        f"on the card, {avail:.1f} GB available on the host")


def counted_kernels():
    from repro_torch.kernels.flash_attention import kernel as KA
    from repro_torch.kernels.flash_decode import kernel as KD
    from repro_torch.kernels.mamba_scan import kernel as KS
    return {"flash_attention": KA, "flash_decode": KD, "selective_scan": KS}


def time_steps(torch, prefill, step, prefill_what, step_what, w_bytes,
               who="serve"):
    """Time a prefill and a decode step with CUDA events, beside the least
    time to read the weights once, and profile both (a diagnostic: the run
    goes on without a trace)."""
    prefill_ms = cuda_ms(prefill, torch, 5)
    step_ms = cuda_ms(step, torch, 20)
    log(f"{who}: prefill ({prefill_what}) {prefill_ms:.3f} ms, decode step "
        f"({step_what}) {step_ms:.3f} ms; reading the weights once takes "
        f"at least {w_bytes / HBM_BYTES_S * 1e3:.3f} ms")
    for label, fn, ms_call in (("prefill", prefill, prefill_ms),
                               ("decode step", step, step_ms)):
        try:
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
    return prefill_ms, step_ms


def serve_model(torch, dev0, cfg, params, launches, per_prefill, per_step):
    """Serve ``SERVE`` through ``CoexecServer`` on two replicas sharing
    ``params``; check that all are served, that every kernel of the path
    launched ``per_prefill[name]`` times a prefill plus ``per_step[name]``
    times a decode step (and the others never), and that the tokens are
    replica-invariant; time a prefill and a decode step and profile
    both.  Records the path's launch counts in ``launches``."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import (CoexecServer, Replica, RequestQueue,
                                   ServerConfig, make_requests)

    counters = counted_kernels()
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
    held_gb = torch.cuda.memory_allocated(dev0) / 1e9
    torch.cuda.reset_peak_memory_stats(dev0)
    for k in counters.values():
        k.launches = 0
    try:
        out = server.run(RequestQueue(reqs))
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in counters.items()}
        # each group waits on its own stream only, so its busy time is its
        # own packets' (and its throttle's sleep), not the other replica's
        groups = [(g.name, g.busy_time, g.kernel_time, g.packets_done)
                  for g in server.session.devices]
    finally:
        server.close()
    peak_gb = torch.cuda.max_memory_allocated(dev0) / 1e9
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
        + " ".join(f"{name} {n}" for name, n in counts.items())
        + f"; peak memory {peak_gb:.2f} GB ({w_bytes / 1e9:.2f} GB of "
        f"weights; {held_gb:.2f} GB allocated before the run)")
    log("serve: replica groups (host-clock busy s, between their stream's "
        "events s, packets): " + "; ".join(
            f"{n} {b:.3f} / {k:.3f} / {c}" for n, b, k, c in groups))
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
        time_steps(torch, lambda: T.prefill(cfg, params, batch, cache),
                   lambda: T.decode_step(cfg, params, batch[:, :1], cache,
                                         P + gen // 2),
                   f"batch {lws} x {P}", f"batch {lws}, pos {P + gen // 2}",
                   w_bytes)
    del server, reps, out
    torch.cuda.empty_cache()


def card_against_host(torch, dev0, cfg32, p32, label, prompt=None,
                      patches=None):
    """Teacher-forced ``PARITY`` in float32 (TF32 off) with ``p32`` on
    the card (kernels) and then on the host (plain versions); the logits
    must agree within 1e-3 of the largest.  ``prompt`` replaces PARITY's
    prompt length; ``patches`` (numpy, (batch, n, d)) go to the prefill
    (the ``vit_stub`` frontend); an ``encodec_stub`` model takes tokens
    of all its codebooks.  Moves ``p32`` to the host."""
    from repro_torch.models import transformer as T

    B2, P2, n_steps = (PARITY[k] for k in ("batch", "prompt", "steps"))
    P2 = prompt or P2
    cb = ((cfg32.n_codebooks,) if cfg32.frontend == "encodec_stub"
          else ())
    ptoks = np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B2, P2 + n_steps) + cb).astype(np.int32)

    def teacher_forced(device):
        with torch.inference_mode():
            t = torch.as_tensor(ptoks, device=device)
            pt = (None if patches is None
                  else torch.as_tensor(patches, device=device))
            cache = T.init_cache(cfg32, B2, P2 + n_steps, device)
            lg, cache = T.prefill(cfg32, p32, t[:, :P2], cache, patches=pt)
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


def attn_check(torch, randn, B, S, h, kh, d, dtype, timed=False):
    """Hold ``flash_attention`` against ``attention_ref`` on (B, S, h, d)
    queries and (B, S, kh, d) keys and values from ``randn`` at
    ``ATTN_TOL``; with ``timed``, time kernel, plain version and SDPA and
    return the measurements for a kernel record."""
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    F = torch.nn.functional
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
        # the same kernel writing each row's log-sum-exp, as a training
        # forward does: not part of the record's time
        keep_lse_ms=cuda_ms(lambda: KA.flash_attention_fwd(
            q, k, v, keep_lse=True), torch),
        plain_ms=cuda_ms(lambda: RA.attention_ref(q, k, v), torch, 2),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), torch),
        nbytes=elt * (2 * B * S * h * d + 2 * B * S * kh * d),
        ops=4.0 * B * h * d * S * (S + 1) / 2,
        ops_per_s=BF16_OPS_S if dtype == torch.bfloat16 else FP32_OPS_S)
    log(f"  timed {shape}: kernel {res['ms']:.4f} ms (keeping the "
        f"log-sum-exp {res['keep_lse_ms']:.4f} ms), SDPA "
        f"{res['library_ms']:.4f} ms, kernel/SDPA "
        f"{res['ms'] / res['library_ms']:.3f}")
    del q, k, v, qt, kt, vt, got, want, lib
    torch.cuda.empty_cache()
    return res


def decode_check(torch, randn, B, Smax, h, kh, d, pos, dtype, timed=False):
    """Hold ``flash_decode`` against ``decode_attention`` on (B, h, d)
    queries and (B, Smax, kh, d) caches from ``randn`` at ``ATTN_TOL``,
    attending to [0, pos]; with ``timed``, time kernel, plain version and
    SDPA over the live prefix and return the measurements for a kernel
    record."""
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    F = torch.nn.functional
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
    from repro_torch.kernels.flash_decode import kernel as KD

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

    bf16, f32 = torch.bfloat16, torch.float32
    log("kernels of the serving path against their plain versions:")
    serve_a = attn_check(torch, randn, lws, P, H, KH, D, bf16, timed=True)
    long_S = 1024 if args.small else 4096
    long_a = attn_check(torch, randn, 2, long_S, H, KH, D, bf16, timed=True)
    # qwen3-32b's heads: D = 128 runs another instantiation of the kernel
    d128_a = attn_check(torch, randn, 1, long_S, 64, 8, 128, bf16,
                        timed=True)
    attn_check(torch, randn, 2, 1000, H, KH, D, bf16)     # ragged S
    attn_check(torch, randn, 1, 1000, H, KH, D, f32)
    attn_check(torch, randn, 2, 256, 8, 4, 80, f32)   # stablelm-3b's D
    attn_check(torch, randn, 2, 256, 8, 4, 80, bf16)
    attn_check(torch, randn, 1, 384, 16, 2, 128, f32)  # qwen3-32b's D
    attn_check(torch, randn, 1, 384, 16, 2, 128, bf16)
    serve_d = decode_check(torch, randn, lws, P + gen, H, KH, D,
                           P + gen - 1, bf16, timed=True)
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
    long_d = decode_check(torch, randn, long_B, long_Smax, H, KH, D,
                          long_Smax - 1, bf16, timed=True)
    decode_check(torch, randn, 3, 1000, H, KH, D, 700, f32)
    decode_check(torch, randn, 2, 512, 8, 4, 80, 300, bf16)
    decode_check(torch, randn, 2, 512, 16, 2, 128, 511, f32)

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


# the fleet phase (8a): workers (name, throttle, declared requests/s); the
# last is the autoscaler's standby
FLEET_WORKERS = (("w0", 1.0, 4.0), ("w1", 2.0, 2.0), ("spare", 1.0, 4.0))
FLEET = dict(burst=32, tail=16, rate=2.0, slo=600.0)
SMALL_FLEET = dict(burst=12, tail=4, rate=2.0, slo=600.0)
# the autoscaler's times, sized by the card's rounds (a packet of 4
# requests, prefill and 32 tokens, takes ~0.3-1 s on the shared card), not
# by the simulator's defaults
FLEET_SCALE = dict(target_delay_s=1.0, breach_s=0.5, warmup_s=0.5,
                   cooldown_s=1.0, idle_s=2.0, max_replicas=3)
FLEET_TIMEOUT_S = 300.0
# requests of each worker held against a fresh replica
FLEET_INVARIANT = 4


def fleet_phase(args, torch, dev0, launches):
    """Serve llama3.2-1b through ``repro_torch.fleet.FleetServer``: three
    workers on the card sharing one copy of the weights, the third a
    standby that the autoscaler brings in during the burst.  Records the
    phase's launch counts in ``launches`` under "llama3.2-1b fleet"."""
    import threading
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimConfig, SimDevice
    from repro_torch.fleet import (AutoscaleConfig, ElasticAutoscaler,
                                   FleetServer, ReplicaWorker, RouterConfig,
                                   SimReplica, simulate_fleet)
    from repro_torch.serve import (Replica, RequestQueue, ServerConfig,
                                   make_requests, percentile,
                                   poisson_arrivals)

    cfg = get_config("llama3.2-1b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    traffic = SMALL_FLEET if args.small else FLEET
    P, gen, lws = (SERVE[k] for k in ("prompt", "gen", "lws"))
    n_burst, n_tail = traffic["burst"], traffic["tail"]
    n_req = n_burst + n_tail
    counters = counted_kernels()
    params = make_params(torch, dev0, cfg)

    class CountingReplica(Replica):
        """Counts prefill calls and decode steps of ``serve`` and sums its
        host-clock seconds (the throttle's sleep is the server's, outside
        it)."""
        calls = steps = 0
        serve_s = 0.0

        def serve(self, prompts, gen, cache_len=None):
            t0 = time.perf_counter()
            toks = super().serve(prompts, gen, cache_len)
            self.serve_s += time.perf_counter() - t0
            self.calls += 1
            self.steps += gen
            return toks

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n_req, P)).astype(np.int32)
    arrivals = ([0.0] * n_burst
                + poisson_arrivals(n_tail, traffic["rate"],
                                   np.random.default_rng(0)))
    scfg = ServerConfig(scheduler="hguided_deadline", lws=lws, gen=gen,
                        warmup=False)
    reps, workers = {}, []
    for name, throttle, power in FLEET_WORKERS:
        rep = CountingReplica(f"{name}.r", cfg, params, throttle=throttle,
                              device=dev0)
        # warm-up (first launches, library plans) outside the counted run
        rep.serve(np.stack([prompts[0]] * lws), gen, P + gen)
        rep.calls = rep.steps = 0
        rep.serve_s = 0.0
        reps[name] = rep
        workers.append(ReplicaWorker(name, [rep], scfg,
                                     declared_power=power))
    torch.cuda.synchronize()
    asc = ElasticAutoscaler(AutoscaleConfig(**FLEET_SCALE))
    standby = [FLEET_WORKERS[-1][0]]
    fleet = FleetServer(workers, RouterConfig(placement="deadline",
                                              admit="shed"),
                        autoscaler=asc, standby=standby)

    groups = {}                  # every group a session held, by identity
    off_card = []                # (when, group) of any group not on dev0

    def look(when):
        for w in workers:
            for g in w.server.session.devices:
                groups[id(g)] = (w.name, g)
                if not (g.is_cuda and g.device == dev0):
                    off_card.append((when, w.name, g.name, str(g.device)))

    apply_scale = fleet.router.on_scale

    def apply_and_look(ev):
        look(f"before {ev.action} {ev.replica}")
        apply_scale(ev)
        look(f"after {ev.action} {ev.replica}")

    fleet.router.on_scale = apply_and_look
    look("at start")
    reqs = make_requests(arrivals, slo=traffic["slo"],
                         prompt_fn=lambda i: prompts[i])
    held_gb = torch.cuda.memory_allocated(dev0) / 1e9
    torch.cuda.reset_peak_memory_stats(dev0)
    box = {}

    def run():
        try:
            box["out"] = fleet.run(RequestQueue(reqs))
        except BaseException as e:      # re-raised below, on this thread
            box["error"] = e

    for k in counters.values():
        k.launches = 0
    t_run = time.perf_counter()
    runner = threading.Thread(target=run, name="fleet-run", daemon=True)
    runner.start()
    runner.join(FLEET_TIMEOUT_S)
    check(not runner.is_alive(),
          f"fleet: run still going after {FLEET_TIMEOUT_S:.0f} s")
    if "error" in box:
        raise box["error"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = {name: k.launches for name, k in counters.items()}
    look("after the run")
    peak_gb = torch.cuda.max_memory_allocated(dev0) / 1e9
    out = box["out"]
    st = out.stats
    calls = sum(r.calls for r in reps.values())
    steps = sum(r.steps for r in reps.values())
    launches["llama3.2-1b fleet"] = counts

    # ------------------------------------------------------------ checks
    check(st.served == n_req and st.shed == 0,
          f"fleet: {st.served} of {n_req} served, {st.shed} shed")
    check(all(k.split(":")[0] in reps for k in st.dispatch)
          and sum(st.dispatch.values()) == n_req,
          f"fleet: dispatch {st.dispatch}")
    ups = [e for e in fleet.router.scale_events if e.action == "up"]
    spare = standby[0]
    check(any(e.replica == spare for e in ups),
          f"fleet: no scale-up of {spare} "
          f"({[(e.t, e.action, e.replica) for e in asc.events]})")
    served_by = {}
    for r in out.requests:
        served_by.setdefault(r.replica.split(".")[0], []).append(r)
    check(len(served_by.get(spare, [])) > 0, f"fleet: {spare} served none")
    check(not off_card, f"fleet: groups off {dev0}: {off_card}")
    want = {"flash_attention": cfg.n_layers * calls,
            "flash_decode": cfg.n_layers * steps}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"fleet: {n} {name} launches for {calls} prefills and "
              f"{steps} decode steps of {cfg.n_layers} layers (expected "
              f"{want.get(name, 0)})")
    toks = np.stack([out.results[r.rid] for r in reqs])
    check(toks.shape == (n_req, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"fleet: tokens of shape {toks.shape} out of range")

    # replica invariance: each worker's first requests on a fresh replica,
    # padded to the server's packet as the server pads them
    fresh = Replica("ref", cfg, params, device=dev0)
    alone_s = []
    for name, served in sorted(served_by.items()):
        first = sorted(served, key=lambda r: (r.finish, r.rid))
        first = first[:FLEET_INVARIANT]
        rows = [r.prompt for r in first]
        rows += [rows[-1]] * (lws - len(rows))
        t0 = time.perf_counter()
        got = fresh.serve(np.stack(rows), gen, P + gen)[:len(first)]
        alone_s.append(time.perf_counter() - t0)
        check(np.array_equal(got, np.stack([out.results[r.rid]
                                            for r in first])),
              f"fleet: {name}'s tokens not replica-invariant")
    alone = min(alone_s)

    # --------------------------------------------------------------- logs
    lat = [r.latency for r in out.requests]
    log(f"fleet: {n_req} requests ({n_burst} at t=0, {n_tail} at "
        f"{traffic['rate']:g}/s after), served {st.served}, shed {st.shed} "
        f"in {st.duration:.3f} s ({wall:.3f} s wall), "
        f"{st.served * gen / st.duration:.1f} tokens/s, p50 "
        f"{percentile(lat, 50):.3f} s, p99 {percentile(lat, 99):.3f} s, "
        f"SLO attainment {st.slo_attainment:.3f}; {calls} prefills, {steps} "
        f"decode steps, launches "
        + " ".join(f"{name} {n}" for name, n in counts.items())
        + f"; peak memory {peak_gb:.2f} GB ({held_gb:.2f} GB allocated "
        f"before the run)")
    log("fleet: requests per worker " + json.dumps(
        {n: len(v) for n, v in sorted(served_by.items())})
        + f", dispatch {st.dispatch}")
    # a binary submit resets busy_time and packets_done: they are the last
    # round's; kernel_time sums every packet since the group was attached
    log("fleet: groups (last round's host-clock busy s and packets; "
        "between their stream's events s over the run): " + "; ".join(
            f"{w}/{g.name} {g.busy_time:.3f} / {g.packets_done} / "
            f"{g.kernel_time:.3f}" for w, g in groups.values()))
    log(f"fleet: a batch of {lws} (prefill and {gen} tokens) alone on a "
        f"fresh replica {alone:.3f} s; in the fleet, with {len(workers)} "
        f"workers' threads sharing the GIL and the card (batches, serve s, "
        f"s a batch, against alone): " + "; ".join(
            f"{n} {r.calls} / {r.serve_s:.3f} / "
            f"{r.serve_s / max(r.calls, 1):.3f} / "
            f"{r.serve_s / max(r.calls, 1) / alone:.2f}x"
            for n, r in reps.items()))
    log("fleet: scale events (t s, action, worker, queue delay s): "
        + "; ".join(f"{e.t:.3f} {e.action} {e.replica} "
                    f"{e.queue_delay_s:.3f}" for e in asc.events)
        + f"; {json.dumps(asc.summary())}")
    err = [r.finish - fleet.router.predicted[r.rid] for r in out.requests]
    log(f"fleet: router's predicted finish against the measured: mean "
        f"error {np.mean(err):+.3f} s, mean |error| "
        f"{np.mean(np.abs(err)):.3f} s, max |error| "
        f"{np.max(np.abs(err)):.3f} s")

    # the fleet simulator on the same requests, its replicas at the
    # measured per-worker powers (logged beside the run, not a gate)
    powers = {w.name: w.measured_power() or w.declared_power
              for w in workers}
    sim_reps = [SimReplica(w.name, [SimDevice(f"{w.name}.d", powers[w.name])],
                           lws=lws) for w in workers]
    sim = simulate_fleet(
        make_requests(arrivals, slo=traffic["slo"]), sim_reps,
        SimConfig(scheduler="hguided_deadline", seed=0),
        RouterConfig(placement="deadline", admit="shed"),
        autoscaler=ElasticAutoscaler(AutoscaleConfig(**FLEET_SCALE)),
        standby=standby)
    ss = sim.stats
    log(f"fleet: simulate_fleet at the measured powers "
        f"{json.dumps({k: round(v, 3) for k, v in powers.items()})} "
        f"requests/s: served {ss.served}, attainment "
        f"{ss.slo_attainment:.3f} (measured {st.slo_attainment:.3f}), p50 "
        f"{ss.p50_latency:.3f} s (measured {st.p50_latency:.3f}), p99 "
        f"{ss.p99_latency:.3f} s (measured {st.p99_latency:.3f}), duration "
        f"{ss.duration:.3f} s (measured {st.duration:.3f}), scale events "
        + "; ".join(f"{e.t:.3f} {e.action} {e.replica}"
                    for e in sim.scale_events))
    del fleet, workers, reps, fresh, params, out
    torch.cuda.empty_cache()


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


# ------------------------------------------------ MLA and MoE (deepseek)
# the card-against-host check runs the dense first layer and two MoE layers
MOE_PARITY_LAYERS = 3


@contextlib.contextmanager
def recorded_routes():
    """Record every MoE routing while the block runs: a list of (the
    router's probabilities on the host, the chosen experts)."""
    from repro_torch.models import layers as L

    routes, route = [], L.moe_route

    def recorded_route(cfg_, p, x):
        probs, gates, idx = route(cfg_, p, x)
        routes.append((probs.detach().float().cpu(), idx.cpu()))
        return probs, gates, idx

    L.moe_route = recorded_route
    try:
        yield routes
    finally:
        L.moe_route = route


def top_k_margin(routes, k):
    """The smallest margin between the k-th and (k+1)-th router
    probability over ``routes``."""
    return min(float((pr.sort(-1, descending=True).values[..., k - 1]
                      - pr.sort(-1, descending=True).values[..., k]).min())
               for pr, _ in routes)


def routed_card_against_host(torch, dev0, cfg32, p32, label, **kw):
    """``card_against_host`` of an MoE model, which must also route every
    token to the same experts on both sides; logs the smallest margin
    between the k-th and (k+1)-th router probability on the host."""
    with recorded_routes() as routes:
        card_against_host(torch, dev0, cfg32, p32, label, **kw)
    n = len(routes) // 2
    check(n > 0 and len(routes) == 2 * n, f"parity: {len(routes)} routings")
    k = cfg32.moe.top_k
    margin = top_k_margin(routes[n:], k)
    same = all(torch.equal(a[1], b[1]) for a, b in zip(routes[:n],
                                                        routes[n:]))
    log(f"parity {label}: {n} routings a side, the experts chosen "
        f"{'equal' if same else 'NOT equal'} card against host; smallest "
        f"margin between the {k}th and {k + 1}th router probability "
        f"{margin:.3g}")
    check(same, "parity: the card and the host route tokens to other "
                "experts")


def mla_phases(args, torch, dev0, record):
    """flash_attention at MLA's head dim against its plain version (phase
    15); serve deepseek-v2-lite-16b at full width (phase 16); card against
    host in float32 on its first layers, with the routing equal (17)."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    # what the earlier phases left in reference cycles goes before the
    # 31.4 GB of weights come
    free_card(torch, dev0, "deepseek phases")
    cfg = get_config("deepseek-v2-lite-16b")
    if args.small:
        cfg = replace(cfg, n_layers=2)       # the dense layer and one MoE
    m = cfg.mla
    H, D = cfg.n_heads, m.nope_head_dim + m.rope_head_dim
    P, lws = SERVE["prompt"], SERVE["lws"]
    bf16, f32 = torch.bfloat16, torch.float32

    # ------------------------------- phase 15: the kernel at D = 192
    gen_t = torch.Generator(dev0).manual_seed(4)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"flash_attention at MLA's head dim {D} against its plain version:")
    mla_a = attn_check(torch, randn, lws, P, H, H, D, bf16, timed=True)
    long_S = 1024 if args.small else 4096
    long_a = attn_check(torch, randn, 1, long_S, H, H, D, bf16, timed=True)
    attn_check(torch, randn, 2, 1000, H, H, D, bf16)      # ragged S
    attn_check(torch, randn, 2, 77, 4, 2, D, bf16)        # G = 2, ragged
    attn_check(torch, randn, lws, P, H, H, D, f32)
    attn_check(torch, randn, 1, 1000, H, H, D, f32)       # ragged S

    # ---------------------------- phase 16: serve at full width, bf16
    params = make_params(torch, dev0, cfg)
    served = {}
    serve_model(torch, dev0, cfg, params, served,
                per_prefill={"flash_attention": cfg.n_layers}, per_step={})
    record("flash_attention_d192", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:69", mla_a["err"],
           mla_a["ms"], mla_a["plain_ms"], mla_a["nbytes"], mla_a["ops"],
           mla_a["library_ms"], mla_a["shape"] + " (MLA prefill)",
           mla_a["ops_per_s"], n_launches=served["flash_attention"],
           long_shape=long_entry(long_a))

    # ------------- phase 17: card against host, f32, first layers only
    n_par = min(MOE_PARITY_LAYERS, cfg.n_layers)
    head = T.LM(params.embed, list(params.layers[:n_par]),
                params.final_norm, params.lm_head)
    p32 = copy.deepcopy(head).to(torch.float32)
    del params, head
    torch.cuda.empty_cache()
    log(f"parity {cfg.name}: depth cut to the first {n_par} of "
        f"{cfg.n_layers} layers at full width (host memory and time)")
    routed_card_against_host(torch, dev0,
                             replace(cfg, n_layers=n_par, dtype="float32"),
                             p32, f"{cfg.name} ({n_par} layers)")


# ------------------------------ the hybrid period (jamba) and the frontends
# jamba-v0.1-52b's 32 layers hold 103.1 GB of bfloat16 weights: the card
# serves two of its four periods of 8 (16 layers, 52.11 GB)
JAMBA_SERVED_LAYERS = 16
# one period of 4 at full width (the smoke config's period): ``--small``
# serves it, and the card-against-host check runs layers 0, 1, 4 and 5 of
# the served model under it (Mamba + MoE, Mamba + MLP, attention + MoE,
# Mamba + MLP: each of the three layer kinds)
JAMBA_PERIOD4 = dict(n_layers=4, attn_every=4, attn_offset=2)
JAMBA_PARITY_LAYERS = (0, 1, 4, 5)
# internvl2-1b's patch run: 256 patch positions, then 256 text tokens
VLM_RUN = dict(batch=4, patches=256, text=256, gen=32)
# musicgen-large's card-against-host check runs its first 8 layers
AUDIO_PARITY_LAYERS = 8
# the kernels whose records add up the launches of phases 18-21's paths,
# and the path that counted them before
SERVED_KERNELS = {"flash_attention": "llama3.2-1b",
                  "flash_decode": "llama3.2-1b",
                  "selective_scan": "falcon-mamba-7b"}


def jamba_phases(args, torch, dev0):
    """Hold the attention kernels at jamba's heads (D = 128, H = 32, KH =
    8) and serve jamba-v0.1-52b at full width on 16 of its 32 layers
    (phase 18); card against host in float32 on one period of 4 of its
    layers, with the routing equal (19).  Returns (the served path's
    launches, the two kernels' measurements at jamba's shapes)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    free_card(torch, dev0, "jamba phases")
    full = get_config("jamba-v0.1-52b")
    cfg = (replace(full, **JAMBA_PERIOD4) if args.small
           else replace(full, n_layers=JAMBA_SERVED_LAYERS))
    kinds = [(cfg.mixer_kind(i), cfg.mlp_kind(i))
             for i in range(cfg.n_layers)]
    n_attn = sum(m == "attn" for m, _ in kinds)
    log(f"jamba: {cfg.n_layers} of {full.n_layers} layers, {n_attn} "
        f"attention and {cfg.n_layers - n_attn} Mamba, "
        f"{sum(f == 'moe' for _, f in kinds)} MoE: "
        + " ".join(f"{m}+{f}" for m, f in kinds))
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    P, gen, lws = (SERVE[k] for k in ("prompt", "gen", "lws"))
    bf16 = torch.bfloat16
    gen_t = torch.Generator(dev0).manual_seed(5)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log("kernels at jamba's attention heads against their plain versions:")
    attn = attn_check(torch, randn, lws, P, H, KH, D, bf16, timed=True)
    dec = decode_check(torch, randn, lws, P + gen, H, KH, D, P + gen - 1,
                       bf16, timed=True)

    # ------------------ phase 18: serve at full width, 16 layers, bf16
    params = make_params(torch, dev0, cfg)
    served = {}
    serve_model(torch, dev0, cfg, params, served,
                per_prefill={"flash_attention": n_attn,
                             "selective_scan": cfg.n_layers - n_attn},
                per_step={"flash_decode": n_attn})

    # ------- phase 19: card against host, f32, one period of 4 layers
    keep = range(cfg.n_layers) if args.small else JAMBA_PARITY_LAYERS
    cut = replace(full, dtype="float32", **JAMBA_PERIOD4)
    check([(cut.mixer_kind(i), cut.mlp_kind(i)) for i in range(4)]
          == [kinds[i] for i in keep], "jamba parity: the cut's kinds")
    head = T.LM(params.embed, [params.layers[i] for i in keep],
                params.final_norm, params.lm_head)
    del params
    free_card(torch, dev0, f"jamba parity, layers {list(keep)}")
    # in place, tensor by tensor: no second bfloat16 copy on the card
    p32 = head.to(torch.float32)
    log(f"parity {cut.name}: layers {list(keep)} of the served model as "
        f"one period of 4 at full width, "
        f"{T.param_bytes(p32) / 1e9:.2f} GB in float32 on each side")
    routed_card_against_host(torch, dev0, cut, p32,
                             f"{cut.name} (layers {list(keep)})")
    del head, p32
    return served, attn, dec


def vlm_phase(args, torch, dev0):
    """Phase 20: hold the attention kernels at internvl2-1b's heads (G =
    7), serve internvl2-1b at full width without patches, run a prefill
    with 256 patch embeddings and greedy decode steps, and compare card
    against host in float32 on all its layers with patches.  Returns (the
    path's launches, the two kernels' measurements at G = 7)."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    free_card(torch, dev0, "internvl2-1b phase")
    cfg = get_config("internvl2-1b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    H, KH, D, L = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                   cfg.n_layers)
    P, gen, lws = (SERVE[k] for k in ("prompt", "gen", "lws"))
    bf16, f32 = torch.bfloat16, torch.float32
    gen_t = torch.Generator(dev0).manual_seed(6)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"kernels at G = {H // KH} ({H} query heads over {KH}, D = {D}) "
        f"against their plain versions:")
    attn = attn_check(torch, randn, lws, P, H, KH, D, bf16, timed=True)
    attn_check(torch, randn, 2, 1000, H, KH, D, bf16)      # ragged S
    attn_check(torch, randn, 3, 19, H, KH, D, bf16)        # one item + 1
    attn_check(torch, randn, lws, P, H, KH, D, f32)
    attn_check(torch, randn, 1, 1000, H, KH, D, f32)       # ragged S
    dec = decode_check(torch, randn, lws, P + gen, H, KH, D, P + gen - 1,
                       bf16, timed=True)
    decode_check(torch, randn, 3, 1000, H, KH, D, 700, bf16)
    decode_check(torch, randn, 2, 4096, H, KH, D, 4000, f32)

    # ------------- serve without patches, as the JAX package's server does
    params = make_params(torch, dev0, cfg)
    served = {}
    serve_model(torch, dev0, cfg, params, served,
                per_prefill={"flash_attention": L},
                per_step={"flash_decode": L})

    # ------------------- a prefill with patch embeddings, greedy decoding
    B, n, text, gen_p = (VLM_RUN[k] for k in ("batch", "patches", "text",
                                              "gen"))
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, n + text))
                           .astype(np.int32), device=dev0)
    # precomputed patch embeddings at the token embeddings' scale
    patches_np = (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)
    patches = torch.as_tensor(patches_np, device=dev0)
    kernels = counted_kernels()
    for k in kernels.values():
        k.launches = 0
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, n + text + gen_p, dev0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = T.prefill(cfg, params, toks, cache, patches=patches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        first = lg
        tok = lg[:, -1].argmax(-1, keepdim=True)
        out = []
        t0 = time.perf_counter()
        for i in range(gen_p):
            out.append(tok)
            lg, cache = T.decode_step(cfg, params, tok, cache, n + text + i)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        out = torch.cat(out, 1).cpu().numpy()
        decode_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"flash_attention": L, "flash_decode": L * gen_p,
            "selective_scan": 0}
    check(counts == want, f"internvl2-1b with patches: launches {counts}, "
                          f"expected {want}")
    check(bool(torch.isfinite(first).all()) and first.shape == (
        B, 1, cfg.vocab_size), "internvl2-1b with patches: logits")
    check(out.shape == (B, gen_p) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          "internvl2-1b with patches: tokens out of range")
    for name, c in counts.items():
        served[name] = served.get(name, 0) + c
    log(f"internvl2-1b with patches: prefill (batch {B}, {n} patch "
        f"positions + {text} tokens) {prefill_s * 1e3:.3f} ms, {gen_p} "
        f"greedy steps {decode_s:.3f} s (host clock), launches {counts}")
    del cache, first, lg

    # ------------- card against host, f32, all layers, with patches
    p32 = copy.deepcopy(params).to(torch.float32)
    del params
    torch.cuda.empty_cache()
    card_against_host(torch, dev0, replace(cfg, dtype="float32"), p32,
                      f"{cfg.name} ({n} patches)",
                      prompt=n + PARITY["prompt"],
                      patches=patches_np[:PARITY["batch"]])
    del p32
    return served, attn, dec


def audio_phase(args, torch, dev0):
    """Phase 21: hold the attention kernels at musicgen-large's heads (G =
    1, H = 32, D = 64), run musicgen-large at full width through
    ``prefill`` and ``decode_step`` (4 codebooks a position, greedy by
    codebook), its times beside the weight-read bound, and card against
    host in float32 on its first layers.  Returns (the path's launches,
    the two kernels' measurements at its heads)."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    free_card(torch, dev0, "musicgen-large phase")
    cfg = get_config("musicgen-large")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    P, gen, B = (SERVE[k] for k in ("prompt", "gen", "lws"))
    L, CB, V = cfg.n_layers, cfg.n_codebooks, cfg.vocab_size
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    gen_t = torch.Generator(dev0).manual_seed(7)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"kernels at musicgen-large's heads ({H} query heads over {KH}, "
        f"D = {D}) against their plain versions:")
    attn = attn_check(torch, randn, B, P, H, KH, D, bf16, timed=True)
    attn_check(torch, randn, 2, 1000, H, KH, D, bf16)      # ragged S
    attn_check(torch, randn, B, P, H, KH, D, f32)
    attn_check(torch, randn, 1, 1000, H, KH, D, f32)       # ragged S
    dec = decode_check(torch, randn, B, P + gen, H, KH, D, P + gen - 1,
                       bf16, timed=True)
    decode_check(torch, randn, 3, 1000, H, KH, D, 700, bf16)
    decode_check(torch, randn, 2, 1000, H, KH, D, 700, f32)

    params = make_params(torch, dev0, cfg)
    w_bytes = T.param_bytes(params)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, V, (B, P, CB)).astype(np.int32), device=dev0)
    kernels = counted_kernels()
    for k in kernels.values():
        k.launches = 0
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, P + gen, dev0)
        lg, cache = T.prefill(cfg, params, toks, cache)
        first = lg
        tok = lg[:, -1].argmax(-1)[:, None]               # (B, 1, CB)
        out = []
        t0 = time.perf_counter()
        for i in range(gen):
            out.append(tok)
            lg, cache = T.decode_step(cfg, params, tok, cache, P + i)
            tok = lg[:, -1].argmax(-1)[:, None]
        out = torch.cat(out, 1).cpu().numpy()
        decode_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    want = {"flash_attention": L, "flash_decode": L * gen,
            "selective_scan": 0}
    check(counts == want, f"musicgen-large: launches {counts}, expected "
                          f"{want}")
    check(bool(torch.isfinite(first).all())
          and first.shape == (B, 1, CB, V), "musicgen-large: logits")
    check(out.shape == (B, gen, CB) and int(out.min()) >= 0
          and int(out.max()) < V, "musicgen-large: tokens out of range")
    log(f"musicgen-large: batch {B}, prompt {P} x {CB} codebooks, {gen} "
        f"greedy steps (argmax per codebook) {decode_s:.3f} s (host "
        f"clock), tokens {out.shape}, launches {counts}")
    with torch.inference_mode():
        time_steps(torch, lambda: T.prefill(cfg, params, toks, cache),
                   lambda: T.decode_step(cfg, params, toks[:, :1], cache,
                                         P + gen // 2),
                   f"batch {B} x {P} x {CB} codebooks",
                   f"batch {B}, pos {P + gen // 2}", w_bytes,
                   who="musicgen-large")
    del cache, first, lg

    # ------------- card against host, f32, first layers only
    n_par = min(AUDIO_PARITY_LAYERS, L)
    head = T.LM(params.embed, list(params.layers[:n_par]),
                params.final_norm, params.lm_head)
    p32 = copy.deepcopy(head).to(torch.float32)
    del params, head
    torch.cuda.empty_cache()
    log(f"parity {cfg.name}: depth cut to the first {n_par} of {L} layers "
        f"at full width (host memory and time)")
    card_against_host(torch, dev0,
                      replace(cfg, n_layers=n_par, dtype="float32"), p32,
                      f"{cfg.name} ({n_par} layers)")
    del p32
    return counts, attn, dec


# ------------------------------- training the other families (22-25)
# the scan's backward against its plain version: max |err| within
# rtol x each output's largest |value| + atol
SCAN_BWD_TOL = (1e-4, 1e-5)
# jamba-v0.1-52b trained at full width on 2 layers: layer 0 attention +
# MoE (the kind of its layer 4), layer 1 Mamba + MLP (layers 1, 3, 5, 7);
# 3.68 B parameters, 7.36 GB of bfloat16 weights and 29.4 GB of float32
# moments (its period of 4, 6.88 B parameters, does not fit one card with
# its moments and a gradient)
JAMBA_TRAIN = dict(n_layers=2, attn_every=2, attn_offset=0)
# TRAIN_4K's global batch of 256 cut to 4, 4 steps, and its 4,096 tokens
# cut to 2,048: at 4,096 the two groups' first step ran out of the card's
# memory (67.60 GiB allocated and 8.80 GiB reserved unallocated when a
# 2 GiB block of a packet's backward was asked for: each packet's Mamba
# backward holds several (1, S, 8192, 16) float32 tensors beside the
# 36.8 GB of weights and moments and the gradients in flight)
JAMBA_TRAIN_RUN = dict(batch=4, steps=4, seq=2048)
# card against host in float32 on a training step: batch 1 x 256 (the
# internvl2-1b run: 256 patch positions and 256 text tokens)
TRAIN_PARITY_SEQ = 256
# falcon-mamba-7b trained on 8 of its 64 layers: make_train_step, 2 steps
# of batch 2 x 4,096; card against host on its first 2 layers
FALCON_TRAIN = dict(layers=8, batch=2, steps=2, parity_layers=2)
# the frontends: internvl2-1b whole, musicgen-large on 8 of its 48 layers,
# 3 steps each of TRAIN_4K's batch cut to 4; card against host on 2 layers
FRONTEND_TRAIN = {"internvl2-1b": 0, "musicgen-large": 8}
FRONTEND_TRAIN_RUN = dict(batch=4, steps=3, parity_layers=2)


def train_kernels():
    """The four kernel counters a training packet runs."""
    from repro_torch.kernels.flash_attention import kernel as KA
    from repro_torch.kernels.mamba_scan import kernel as KS
    return {"flash_attention": (KA, "launches"),
            "flash_attention_bwd": (KA, "bwd_launches"),
            "selective_scan": (KS, "launches"),
            "selective_scan_bwd": (KS, "bwd_launches")}


def read_counts(reset=False):
    out = {}
    for name, (mod, attr) in train_kernels().items():
        out[name] = getattr(mod, attr)
        if reset:
            setattr(mod, attr, 0)
    return out


def per_packet(cfg):
    """Launches a training packet makes: each attention and Mamba layer's
    forward kernel twice (the forward and its rematerialised recompute)
    and its backward once."""
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - n_attn
    return {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "selective_scan": 2 * n_mamba, "selective_scan_bwd": n_mamba}


def profile_step(torch, fn):
    """Run ``fn`` (one training step) under ``torch.profiler``: returns
    (its result, a log line of the card's busy share and top kernels, the
    busy share) or (result, a line saying why not, None)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:           # a diagnostic: the run goes on without a breakdown
        kern = sorted(
            ((getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) / 1e3,
              e.key) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            reverse=True)
    except Exception as e:
        return out, f"no breakdown ({e!r})", None
    busy = sum(ms for ms, _ in kern)
    if busy <= 0:
        return out, "no device time in the trace", None
    by = {what: sum(ms for ms, k in kern if any(x in k for x in keys))
          for what, keys in (
              ("scan forward", ("selective_scan_kernel",)),
              ("scan backward", ("selective_scan_bwd",)),
              ("dC sum", ("scan_dc_sum",)),
              ("attention forward", ("flash_fwd",)),
              ("attention backward", ("bwd_dkdv", "bwd_dq", "bwd_dsum")))}
    line = (f"{busy / 1e3:.3f} s of kernels in {wall:.3f} s (busy "
            f"{busy / 1e3 / wall:.1%}); " + ", ".join(
                f"{k} {ms:.1f} ms" for k, ms in by.items() if ms)
            + "; top: " + "; ".join(f"{ms:.1f} ms {k[:50]}"
                                    for ms, k in kern[:8]))
    return out, line, busy / 1e3 / wall


def held_out_loss(torch, dev0, cfg, params, pipeline, step):
    """(objective, loss, aux) of ``make_loss_fn`` on the pipeline's whole
    batch at ``step``, one row at a time without gradients, averaged over
    the rows.  The losses a training step reports are each on its own
    step's tokens, and a packet's tokens depend on its rows (the pipeline
    seeds a packet by its row range), so two steps' losses differ by their
    data as well as by the training between them; this one batch is the
    same before and after."""
    from repro_torch.training.step import make_loss_fn
    loss_fn = make_loss_fn(cfg)
    data = pipeline.batch_at(step)
    rows = len(data["tokens"])
    out = np.zeros(3)
    with torch.no_grad():
        for r in range(rows):
            total, m = loss_fn(params, {
                k: torch.as_tensor(v[r:r + 1], device=dev0)
                for k, v in data.items()})
            out += [float(total), float(m["loss"]), float(m["aux"])]
    return tuple(out / rows)


def hetero_train(torch, dev0, cfg, seq, batch, steps, label,
                 must_learn=False, held_out=False):
    """Train ``cfg`` (random weights from seed 0) through
    ``HeteroDPTrainer``: two groups on ``dev0`` (throttles 1 and 2),
    ``SyntheticPipeline`` (seed 1234), lws 1, AdamW (``TRAIN_OPT``).
    Every loss finite, every step's tokens, rows on both groups (with
    ``must_learn``, the last loss below the first) and each kernel's
    launches (counters set to 0 before each step) ``per_packet`` times
    the step's packets; one more step under the profiler.  With
    ``held_out``, the objective on one batch that no step trains on
    (``held_out_loss``) is lower after the steps and the profiled step
    than before the first.  Returns (the parameters, a summary with the
    launches of the checked steps)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.device import DeviceGroup
    from repro_torch.core.hetero_dp import HeteroDPTrainer
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig

    t0 = time.perf_counter()
    opt = OptConfig(**TRAIN_OPT)
    params = T.init_params(cfg, torch.Generator(dev0).manual_seed(0))
    state = adamw.init_state(params, opt)
    torch.cuda.synchronize()
    total, active = T.param_count(cfg)
    log(f"train {label}: {cfg.n_layers} layers ("
        + " ".join(f"{cfg.mixer_kind(i)}+{cfg.mlp_kind(i)}"
                   for i in range(cfg.n_layers))
        + f"), d_model {cfg.d_model}, {cfg.dtype}, {total:,} parameters "
        f"({T.param_bytes(params) / 1e9:.3f} GB) and float32 moments made "
        f"on the card in {time.perf_counter() - t0:.2f} s; seq {seq}, "
        f"global batch {batch}, lws {TRAIN['lws']}, {steps} steps")
    shape = ShapeConfig(f"train_{seq}_batch{batch}", seq, batch, "train")
    pipeline = SyntheticPipeline(cfg, shape, DataConfig(seed=TRAIN["seed"]))
    groups = [DeviceGroup("g0", device=dev0, throttle=1.0),
              DeviceGroup("g1", device=dev0, throttle=2.0)]
    trainer = HeteroDPTrainer(cfg, opt, shape, groups, pipeline,
                              lws=TRAIN["lws"])
    want1 = per_packet(cfg)
    run = dict.fromkeys(want1, 0)
    if held_out:
        before = held_out_loss(torch, dev0, cfg, state.params, pipeline,
                               steps + 1)
    reports, rows = [], {g.name: 0 for g in groups}
    torch.cuda.reset_peak_memory_stats(dev0)
    retries0 = torch.cuda.memory_stats(dev0).get("num_alloc_retries", 0)
    try:
        for i in range(steps):
            read_counts(reset=True)
            state, rep = trainer.step(state, i)
            got = read_counts()
            want = {k: v * rep.packets for k, v in want1.items()}
            check(got == want, f"train {label} step {i}: launches {got}, "
                               f"expected {want} ({rep.packets} packets)")
            check(math.isfinite(rep.loss), f"train {label} step {i}: loss "
                                           f"{rep.loss}")
            check(rep.tokens == batch * seq, f"train {label} step {i}: "
                                             f"{rep.tokens} tokens")
            for k in run:
                run[k] += got[k]
            for k, v in rep.device_rows.items():
                rows[k] += v
            reports.append(rep)
            log(f"train {label} step {i}: loss {rep.loss:.4f}, "
                f"{rep.step_time_s:.3f} s, "
                f"{rep.tokens / rep.step_time_s:.0f} tokens/s, balance "
                f"{rep.balance:.3f}, {rep.packets} packets, rows "
                f"{rep.device_rows}, launches {got}, failures "
                f"{rep.failures}")
        peak = torch.cuda.max_memory_allocated(dev0)
        reserved = torch.cuda.max_memory_reserved(dev0)
        # a retry frees the allocator's cached blocks and synchronises
        # the card (each group's stream has blocks of its own)
        retries = (torch.cuda.memory_stats(dev0).get("num_alloc_retries", 0)
                   - retries0)
        (state, rep), line, busy = profile_step(
            torch, lambda: trainer.step(state, steps))
        log(f"profile train {label} step: {line}")
    finally:
        trainer.close()
    losses = [r.loss for r in reports]
    check(all(v > 0 for v in rows.values()),
          f"train {label}: a group ran no rows ({rows})")
    if must_learn:
        check(losses[-1] < losses[0], f"train {label}: loss went from "
                                      f"{losses[0]:.4f} to {losses[-1]:.4f}")
    if held_out:
        after = held_out_loss(torch, dev0, cfg, state.params, pipeline,
                              steps + 1)
        log(f"train {label}: on the held-out batch (step {steps + 1}) "
            f"objective {before[0]:.6f} -> {after[0]:.6f}, loss "
            f"{before[1]:.6f} -> {after[1]:.6f}, aux {before[2]:.5f} -> "
            f"{after[2]:.5f} after {steps + 1} steps")
        check(after[0] < before[0], f"train {label}: the held-out objective "
                                    f"went from {before[0]:.6f} to "
                                    f"{after[0]:.6f}")
    steady = reports[1:] or reports
    step_s = sum(r.step_time_s for r in steady) / len(steady)
    summary = dict(step_s=step_s, tokens_s=batch * seq / step_s, busy=busy,
                   peak_gb=peak / 1e9, launches=run, losses=losses)
    log(f"train {label}: losses {[round(x, 4) for x in losses]}; steps "
        f"2-{len(reports)} {step_s:.3f} s a step, "
        f"{batch * seq / step_s:.0f} tokens/s; rows {rows}; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated; reserved "
        f"{reserved / 1e9:.2f} GB, {retries} allocator retries in the "
        f"{len(reports)} steps); launches in the run {run}")
    del trainer, state
    return params, summary


def train_card_against_host(torch, dev0, cfg32, p32, batch, label):
    """One loss and gradient in float32 (TF32 off), ``p32`` on the card
    (kernels) and a copy on the host (plain versions), on the numpy
    ``batch``: the loss within 1e-4 relative and every gradient within
    1e-3 of its parameter's largest |g|.  With MoE layers, every token
    routed to the same experts on both sides and in the rematerialised
    recompute as in the forward; the smallest top-k margin is logged."""
    import copy

    from repro_torch.training.step import make_grad_fn

    memo = {id(p): torch.nn.Parameter(p.detach().to("cpu"),
                                      requires_grad=True)
            for p in p32.parameters()}
    host32 = copy.deepcopy(p32, memo)
    p32.requires_grad_(True)
    grad_fn = make_grad_fn(cfg32)
    with recorded_routes() as routes:
        t0 = time.perf_counter()
        (lc, mc), gc = grad_fn(p32, {k: torch.as_tensor(v, device=dev0)
                                     for k, v in batch.items()})
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        n_card = len(routes)
        t0 = time.perf_counter()
        (lh, mh), gh = grad_fn(host32, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        t_host = time.perf_counter() - t0
    rel = abs(float(lc) - float(lh)) / abs(float(lh))
    check(math.isfinite(float(lc)) and rel <= 1e-4,
          f"train parity {label}: loss {float(lc)} on the card, "
          f"{float(lh)} on the host ({rel:.3g} relative)")
    worst = 0.0
    for n, w in gh.items():
        top = float(w.abs().max())
        err = float((gc[n].cpu() - w).abs().max())
        check(err <= 1e-3 * top,
              f"train parity {label}: {n} gradient differs by {err:.3g}, "
              f"above 1e-3 of its largest |g| {top:.3g}")
        worst = max(worst, err / max(top, 1e-30))
    route_note = ""
    if cfg32.moe.n_routed:
        card_r, host_r = routes[:n_card], routes[n_card:]
        m = len(host_r) // 2
        check(m > 0 and len(card_r) == len(host_r) == 2 * m,
              f"train parity {label}: {len(card_r)} and {len(host_r)} "
              f"routings")
        check(all(torch.equal(a[1], b[1]) for a, b in zip(card_r, host_r)),
              f"train parity {label}: the card and the host route tokens "
              f"to other experts")
        # the recompute runs the layers in reverse
        for side, rs in (("card", card_r), ("host", host_r)):
            check(all(torch.equal(rs[i][1], rs[2 * m - 1 - i][1])
                      for i in range(m)),
                  f"train parity {label}: the recompute on the {side} "
                  f"routes other than the forward")
        k = cfg32.moe.top_k
        margin = top_k_margin(host_r, k)
        route_note = (f"; {m} routings a pass, experts equal card against "
                      f"host and recompute against forward, smallest "
                      f"top-{k} margin {margin:.3g}")
    log(f"train parity {label} float32 (TF32 off): loss card "
        f"{float(lc):.6f} host {float(lh):.6f} ({rel:.3g} relative, limit "
        f"1e-4), aux card {float(mc['aux']):.6g} host "
        f"{float(mh['aux']):.6g}; gradients within {worst:.3g} of each "
        f"parameter's largest |g| (limit 1e-3){route_note}; card "
        f"{t_card:.2f} s, host {t_host:.2f} s")
    del gc, gh, host32


def scan_bwd_check(torch, dev0, gen_t, B, S, d, s, nonzero=False,
                   timed=False):
    """Hold ``selective_scan_bwd``, fed the states the forward keeps,
    against ``selective_scan_bwd_ref`` at ``SCAN_BWD_TOL``, two calls
    bitwise equal; with ``timed``, time kernel and plain version and
    return the measurements for a kernel record."""
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS

    def randn(*shape):
        return torch.randn(shape, generator=gen_t, device=dev0)

    a = 0.5 + 0.49 * torch.rand((B, S, d, s), generator=gen_t, device=dev0)
    b, C, dy = randn(B, S, d, s) * 0.1, randn(B, S, s), randn(B, S, d)
    h0, dhT = ((randn(B, d, s), randn(B, d, s)) if nonzero
               else (None, None))
    _, _, states = KS.selective_scan_fwd(a, b, C, h0, keep_states=True)
    got = KS.selective_scan_bwd(a, b, C, h0, dy, dhT, states)
    again = KS.selective_scan_bwd(a, b, C, h0, dy, dhT, states)
    want = RS.selective_scan_bwd_ref(a, b, C, h0, dy, dhT)
    shape = (f"B={B} S={S} di={d} ds={s} float32"
             + (" h0 dhT" if nonzero else ""))
    rtol, atol = SCAN_BWD_TOL
    err = 0.0
    for name, g, r, w in zip(("da", "db", "dC", "dh0"), got, again, want):
        check(torch.equal(g, r), f"selective_scan_bwd {shape}: {name} "
                                 f"differs between two calls")
        e, top = float((g - w).abs().max()), float(w.abs().max())
        check(e <= rtol * top + atol, f"selective_scan_bwd {shape}: {name} "
                                      f"max |err| {e:.3g} above {rtol} x "
                                      f"{top:.3g} + {atol}")
        err = max(err, e)
    log(f"  selective_scan_bwd {shape}: max abs err {err:.3g}, two calls "
        f"bitwise equal")
    res = None
    if timed:
        # a, b, C, dy, the kept states (and h0, dhT) read once; da, db, dC
        # and dh0 written once; per (t, d, s) about 8 operations: the
        # state's recompute (2), g (2), da (1), the carry (1), dC's term
        # and its share of the sum (2)
        n_st = states.numel()
        res = dict(
            err=err, shape=shape,
            ms=cuda_ms(lambda: KS.selective_scan_bwd(a, b, C, h0, dy, dhT,
                                                     states), torch),
            plain_ms=cuda_ms(lambda: RS.selective_scan_bwd_ref(
                a, b, C, h0, dy, dhT), torch, 1),
            library_ms=None,
            nbytes=4.0 * (4 * B * S * d * s + 2 * B * S * s + B * S * d
                          + n_st + B * d * s * (3 if nonzero else 1)),
            ops=8.0 * B * S * d * s, ops_per_s=FP32_OPS_S)
        log(f"  timed {shape}: kernel {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms")
    del a, b, C, dy, h0, dhT, states, got, again, want
    torch.cuda.empty_cache()
    return res


def scan_bwd_phase(args, torch, dev0):
    """Phase 22: the scan's backward kernel against its plain version at
    the training packet (timed) and at its edges.  Returns the training
    packet's measurements."""
    from repro_torch.configs import get_config

    free_card(torch, dev0, "selective_scan_bwd phase")
    cfg = get_config("jamba-v0.1-52b")
    di, ds = cfg.d_inner, cfg.ssm.d_state
    gen_t = torch.Generator(dev0).manual_seed(8)
    log("selective_scan_bwd against its plain version:")
    S = 1024 if args.small else TRAIN["seq"]
    packet = scan_bwd_check(torch, dev0, gen_t, 1, S, di, ds, timed=True)
    # S not a multiple of 16, S = 1, ds = 8 and 32, di not a multiple of
    # a CTA's channels, non-zero h0 and dhT
    for B, S, d, s in ((2, 1000, 1000, 16), (1, 1, 8192, 16),
                       (2, 333, 520, 8), (1, 77, 300, 32), (3, 16, 33, 5)):
        scan_bwd_check(torch, dev0, gen_t, B, S, d, s, nonzero=True)
    scan_bwd_check(torch, dev0, gen_t, 1, 100, 4100, 16)
    return packet


def jamba_train_phases(args, torch, dev0):
    """Phase 23: the attention backward at jamba's heads, then
    jamba-v0.1-52b trained at full width on 2 layers through
    ``HeteroDPTrainer``; phase 24 (first half): card against host in
    float32 on those 2 layers with the routing equal.  Returns (the
    training run's summary, the attention backward at jamba's heads)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.configs.base import ShapeConfig

    free_card(torch, dev0, "jamba training phases")
    full = get_config("jamba-v0.1-52b")
    cfg = replace(full, **JAMBA_TRAIN)
    check([(cfg.mixer_kind(i), cfg.mlp_kind(i)) for i in range(2)]
          == [("attn", "moe"), ("mamba", "dense")]
          and (full.mixer_kind(4), full.mlp_kind(4)) == ("attn", "moe")
          and (full.mixer_kind(1), full.mlp_kind(1)) == ("mamba", "dense"),
          "jamba training: the cut's layer kinds")
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen_t = torch.Generator(dev0).manual_seed(9)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    S = 1024 if args.small else TRAIN["seq"]
    log(f"flash_attention_bwd at jamba's heads ({H}/{KH}, D = {D}):")
    attn = attn_bwd_check(torch, randn, 1, S, H, KH, D, torch.bfloat16,
                          timed=True)
    attn_bwd_check(torch, randn, 1, 1000, H, KH, D, torch.float32)

    # --------------------- phase 23: train at full width, 2 layers, bf16
    B, S = ((2, 1024) if args.small
            else (JAMBA_TRAIN_RUN["batch"], JAMBA_TRAIN_RUN["seq"]))
    params, summary = hetero_train(
        torch, dev0, cfg, S, B, JAMBA_TRAIN_RUN["steps"],
        f"{cfg.name} (2 of {full.n_layers} layers)", held_out=True)

    # ------------- phase 24: card against host, f32, the same 2 layers
    free_card(torch, dev0, "jamba training parity")
    p32 = params.to(torch.float32)       # in place, tensor by tensor
    cfg32 = replace(cfg, dtype="float32")
    batch = SyntheticPipeline(cfg32, ShapeConfig(
        "parity", TRAIN_PARITY_SEQ, 1, "train")).batch_at(0)
    train_card_against_host(torch, dev0, cfg32, p32, batch,
                            f"{cfg.name} (2 layers)")
    del params, p32
    return summary, attn


def falcon_train_phase(args, torch, dev0):
    """Phase 24 (second half): falcon-mamba-7b on 8 of its 64 layers, 2
    ``make_train_step`` steps of batch 2 x 4,096 (8 scan backward calls a
    step) and one more under the profiler, then card against host in
    float32 on its first 2 layers."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import make_train_step

    free_card(torch, dev0, "falcon-mamba-7b training phase")
    full = get_config("falcon-mamba-7b")
    n = 2 if args.small else FALCON_TRAIN["layers"]
    cfg = replace(full, n_layers=n)
    B, S = FALCON_TRAIN["batch"], 1024 if args.small else TRAIN["seq"]
    opt = OptConfig(**TRAIN_OPT)
    params = T.init_params(cfg, torch.Generator(dev0).manual_seed(0))
    state = adamw.init_state(params, opt)
    pipeline = SyntheticPipeline(cfg, ShapeConfig("falcon", S, B, "train"),
                                 DataConfig(seed=TRAIN["seed"]))
    step_fn = make_train_step(cfg, opt)
    want = per_packet(cfg)
    run = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats(dev0)
    times = []
    for i in range(FALCON_TRAIN["steps"]):
        batch = {k: torch.as_tensor(v, device=dev0)
                 for k, v in pipeline.batch_at(i).items()}
        read_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        times.append(time.perf_counter() - t0)
        got = read_counts()
        check(got == want, f"train {cfg.name} step {i}: launches {got}, "
                           f"expected {want}")
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"train {cfg.name} step {i}: loss {loss}, grad norm {gnorm}")
        for k in run:
            run[k] += got[k]
        log(f"train {cfg.name} ({n} of {full.n_layers} layers) step {i}: "
            f"loss {loss:.4f}, grad norm {gnorm:.4f}, {times[-1]:.3f} s, "
            f"{B * S / times[-1]:.0f} tokens/s, launches {got}")
    peak = torch.cuda.max_memory_allocated(dev0)
    batch = {k: torch.as_tensor(v, device=dev0)
             for k, v in pipeline.batch_at(len(times)).items()}
    (state, _), line, busy = profile_step(torch,
                                          lambda: step_fn(state, batch))
    log(f"profile train {cfg.name} step: {line}")
    log(f"train {cfg.name}: batch {B} x {S}, peak memory "
        f"{peak / 1e9:.2f} GB")
    n_par = min(FALCON_TRAIN["parity_layers"], n)
    head = T.LM(params.embed, list(params.layers[:n_par]),
                params.final_norm, params.lm_head)
    del state, params
    free_card(torch, dev0, "falcon-mamba-7b training parity")
    p32 = head.to(torch.float32)
    cfg32 = replace(cfg, n_layers=n_par, dtype="float32")
    batch = SyntheticPipeline(cfg32, ShapeConfig(
        "parity", TRAIN_PARITY_SEQ, 1, "train")).batch_at(0)
    train_card_against_host(torch, dev0, cfg32, p32, batch,
                            f"{cfg.name} (first {n_par} layers)")
    del head, p32
    step_s = times[-1]
    return dict(step_s=step_s, tokens_s=B * S / step_s, busy=busy,
                peak_gb=peak / 1e9, launches=run)


def frontend_train_phase(args, torch, dev0):
    """Phase 25: the attention backward at internvl2-1b's G = 7 and
    musicgen-large's 32/32 heads; each model trained 3 steps through
    ``HeteroDPTrainer`` (internvl2-1b with 256 patches a row, musicgen's
    (B, S, 4) tokens); card against host in float32 on 2 layers of each
    (the patch positions out of the loss, the codebooks averaged).
    Returns ({model: summary}, {model: the attention backward at its
    heads})."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import transformer as T

    summaries, attn = {}, {}
    bf16, f32 = torch.bfloat16, torch.float32
    gen_t = torch.Generator(dev0).manual_seed(10)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    S = 1024 if args.small else TRAIN["seq"]
    for name, layers in FRONTEND_TRAIN.items():
        free_card(torch, dev0, f"{name} training phase")
        full = get_config(name)
        n = 2 if args.small else (layers or full.n_layers)
        cfg = replace(full, n_layers=n)
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        log(f"flash_attention_bwd at {name}'s heads ({H}/{KH}, G = "
            f"{H // KH}, D = {D}):")
        attn[name] = attn_bwd_check(torch, randn, 1, S, H, KH, D, bf16,
                                    timed=True)
        attn_bwd_check(torch, randn, 2, 1000, H, KH, D, bf16)   # ragged S
        attn_bwd_check(torch, randn, 1, 1000, H, KH, D, f32)
        attn_bwd_check(torch, randn, 3, 19, H, KH, D, bf16)
        params, summaries[name] = hetero_train(
            torch, dev0, cfg, S, FRONTEND_TRAIN_RUN["batch"],
            FRONTEND_TRAIN_RUN["steps"],
            f"{name} ({n} of {full.n_layers} layers)")
        n_par = min(FRONTEND_TRAIN_RUN["parity_layers"], n)
        head = T.LM(params.embed, list(params.layers[:n_par]),
                    params.final_norm, params.lm_head)
        del params
        free_card(torch, dev0, f"{name} training parity")
        p32 = head.to(torch.float32)
        cfg32 = replace(cfg, n_layers=n_par, dtype="float32")
        # internvl2-1b: 256 patch positions, then 256 text tokens
        seq = TRAIN_PARITY_SEQ + (cfg.n_patches
                                  if cfg.frontend == "vit_stub" else 0)
        batch = SyntheticPipeline(cfg32, ShapeConfig(
            "parity", seq, 1, "train")).batch_at(0)
        train_card_against_host(torch, dev0, cfg32, p32, batch,
                                f"{name} (first {n_par} layers, "
                                f"tokens {batch['tokens'].shape}"
                                + (f", patches {batch['patches'].shape}"
                                   if "patches" in batch else "") + ")")
        del head, p32
    return summaries, attn


# ------------------------------------------------------------ training path
# the training phase: TRAIN_4K's sequence, its global batch of 256 cut to
# 8 (two groups on one card; the 2.47 GB of bf16 weights and 9.89 GB of
# float32 moments leave about 60 GB for rows in flight)
TRAIN = dict(seq=4096, batch=8, steps=6, lws=1, seed=1234)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
# card against host in float32 on the first layers at full width
TRAIN_PARITY = dict(layers=2, batch=2, seq=128, pair_batch=4)
# AdamW's first step moves each element by about lr * g / (|g| + eps):
# where a gradient lies within the two sides' rounding of zero, its sign
# may differ and the two updated values may lie up to 2 lr apart.  So the
# updated parameters are held to 1e-3 of each parameter's largest |value|
# everywhere but at most TRAIN_FLIPS of all elements, each within 2 lr of
# the other side (card against host on the first 2 layers: 3 to 5 of
# 384 million elements outside, PERF.md section 6)
TRAIN_FLIPS = 1e-6
# the backward kernel against its plain version: max |err| over each
# output's largest |value|
ATTN_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def check_updates(torch, got, want, lr, label):
    """``got`` and ``want``: two updated models (same structure; ``got``
    anywhere, ``want`` on the host).  Every element within 1e-3 of its
    parameter's largest |value|, except at most TRAIN_FLIPS of all
    elements, each within 2 lr more.  Returns (worst share of its tol,
    elements outside, elements)."""
    worst, outside, total = 0.0, 0, 0
    for (n, a), b in zip(got.named_parameters(), want.parameters()):
        a = a.detach().to("cpu", torch.float32)
        b = b.detach().float()
        tol = 1e-3 * float(b.abs().max())
        d = (a - b).abs()
        over = d > tol
        outside += int(over.sum())
        total += d.numel()
        check(bool((d <= tol + 2 * lr).all()),
              f"{label}: {n} differs by {float(d.max()):.3g}, above "
              f"{tol:.3g} + 2 lr")
        worst = max(worst, float((d * ~over).max()) / max(tol, 1e-30))
    check(outside <= TRAIN_FLIPS * total,
          f"{label}: {outside} of {total} elements outside 1e-3 of their "
          f"parameter's largest |value|")
    return worst, outside, total


def training_phases(args, torch, dev0, launches, attach):
    """Train llama3.2-1b at full width through ``HeteroDPTrainer`` and
    ``launch.train`` on the card (phase 12); card against host in float32,
    the paper's ``[cuda:0, cpu]`` pair and a checkpoint round trip
    (phase 13)."""
    import contextlib
    import copy
    import io
    import re
    import tempfile
    from dataclasses import replace

    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TRAIN_4K, ShapeConfig
    from repro_torch.core.device import DeviceGroup
    from repro_torch.core.hetero_dp import HeteroDPTrainer
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import make_grad_fn, make_train_step

    cfg = get_config("llama3.2-1b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    L = cfg.n_layers
    S, B = TRAIN["seq"], TRAIN["batch"]
    check(S == TRAIN_4K.seq_len, "training: not TRAIN_4K's sequence")
    opt = OptConfig(**TRAIN_OPT)

    # ------------------------------------------- 12. train at full width
    params, run = hetero_train(torch, dev0, cfg, S, B, TRAIN["steps"],
                               cfg.name, must_learn=True)
    launches["flash_attention_bwd"] = run["launches"]["flash_attention_bwd"]
    attach("flash_attention", train_launches=run["launches"]
           ["flash_attention"])

    # the launcher, in-process: 2 steps of 4 rows, 2 microbatches each
    p32 = copy.deepcopy(T.LM(params.embed,
                             list(params.layers[:TRAIN_PARITY["layers"]]),
                             params.final_norm, params.lm_head)
                        ).to(torch.float32)
    del params
    torch.cuda.empty_cache()
    argv = ["--arch", "llama3.2-1b", "--steps", "2", "--seq", str(S),
            "--batch", "4", "--accum", "2", "--log-every", "1"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = LT.main(argv)
    text = out.getvalue()
    found = re.findall(r"loss=(\S+) gnorm=(\S+)", text)
    check(rc == 0 and len(found) == 2
          and all(math.isfinite(float(x)) for pair in found for x in pair),
          f"launch.train: rc {rc}, output {text!r}")
    log(f"launch.train {' '.join(argv)}: {time.perf_counter() - t0:.1f} s; "
        + " | ".join(line for line in text.splitlines() if line))
    torch.cuda.empty_cache()

    # ----------------------- 13. card against host, f32, first layers
    n_par = TRAIN_PARITY["layers"]
    cfg32 = replace(cfg, n_layers=n_par, dtype="float32")
    log(f"train parity {cfg.name}: depth cut to the first {n_par} of {L} "
        f"layers at full width (host memory and time), float32, TF32 off")
    pshape = ShapeConfig("parity", TRAIN_PARITY["seq"],
                         TRAIN_PARITY["batch"], "train")
    toks = SyntheticPipeline(cfg32, pshape).batch_at(0)["tokens"]
    host32 = copy.deepcopy(p32).to("cpu")
    grad_fn = make_grad_fn(cfg32)
    for p in (p32, host32):
        p.requires_grad_(True)
    t0 = time.perf_counter()
    (lc, _), gc = grad_fn(p32, {"tokens": torch.as_tensor(toks, device=dev0)})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    (lh, _), gh = grad_fn(host32, {"tokens": torch.from_numpy(toks)})
    t_host = time.perf_counter() - t0
    rel = abs(float(lc) - float(lh)) / abs(float(lh))
    check(rel <= 1e-4, f"train parity: loss {float(lc)} on the card, "
                       f"{float(lh)} on the host ({rel:.3g} relative)")
    worst_g = 0.0
    for n, w in gh.items():
        top = float(w.abs().max())
        err = float((gc[n].cpu() - w).abs().max())
        check(err <= 1e-3 * top,
              f"train parity: {n} gradient differs by {err:.3g}, above "
              f"1e-3 of its largest |g| {top:.3g}")
        worst_g = max(worst_g, err / max(top, 1e-30))
    sc = adamw.apply_updates(adamw.init_state(p32, opt), gc, opt)[0]
    sh = adamw.apply_updates(adamw.init_state(host32, opt), gh, opt)[0]
    worst_p, outside, n_el = check_updates(torch, sc.params, sh.params,
                                           opt.lr, "train parity")
    log(f"train parity: loss card {float(lc):.6f} host {float(lh):.6f} "
        f"({rel:.3g} relative, limit 1e-4); gradients within "
        f"{worst_g:.3g} of each parameter's largest |g| (limit 1e-3); "
        f"after one AdamW step the parameters within {worst_p:.3g} of "
        f"1e-3 of their largest |value|, {outside} of {n_el} elements "
        f"outside (at most {TRAIN_FLIPS:g} of them); card {t_card:.2f} s, "
        f"host {t_host:.2f} s")
    del gc, gh, sc, sh, host32

    # the paper's pair against the card alone, one step from one state
    class FixedBatch:
        """Rows [r0, r1) of one batch: every packetisation trains on the
        same tokens (the pipeline draws a row range from its own seed)."""

        def __init__(self, toks):
            self.toks = toks

        def batch_at(self, step, rows=None):
            return {"tokens": self.toks[rows or slice(None)]}

    PB = TRAIN_PARITY["pair_batch"]
    pair_shape = ShapeConfig("pair", TRAIN_PARITY["seq"], PB, "train")
    ptoks = SyntheticPipeline(cfg32, pair_shape).batch_at(0)["tokens"]
    start = {n: p.detach().clone() for n, p in p32.named_parameters()}
    results = {}
    for label, fleet_ in (
            ("cuda0+cpu", [DeviceGroup("cuda0", device=dev0),
                           DeviceGroup("cpu", device="cpu")]),
            ("cuda0", [DeviceGroup("cuda0", device=dev0)])):
        with torch.no_grad():
            for n, p in p32.named_parameters():
                p.copy_(start[n])
        st = adamw.init_state(p32, opt)
        tr = HeteroDPTrainer(cfg32, opt, pair_shape, fleet_,
                             FixedBatch(ptoks), lws=1)
        try:
            t0 = time.perf_counter()
            st, rep = tr.step(st, 0)
            wall = time.perf_counter() - t0
        finally:
            tr.close()
        results[label] = (copy.deepcopy(st.params).to("cpu"), rep)
        log(f"train pair {label}: loss {rep.loss:.6f}, {wall:.2f} s, rows "
            f"{rep.device_rows}, {rep.packets} packets, balance "
            f"{rep.balance:.3f}")
    prep, srep = results["cuda0+cpu"][1], results["cuda0"][1]
    check(prep.device_rows.get("cpu", 0) > 0,
          f"train pair: the host group ran no rows ({prep.device_rows})")
    check(abs(prep.loss - srep.loss) <= 1e-4 * abs(srep.loss),
          f"train pair: loss {prep.loss} against {srep.loss}")
    worst_p, outside, n_el = check_updates(
        torch, results["cuda0+cpu"][0], results["cuda0"][0], opt.lr,
        "train pair")
    log(f"train pair: [cuda:0, cpu] against [cuda:0] alone: parameters "
        f"within {worst_p:.3g} of 1e-3 of their largest |value|, "
        f"{outside} of {n_el} elements outside")
    del results

    # checkpoint: async save, restore into a fresh state, one more step
    with torch.no_grad():
        for n, p in p32.named_parameters():
            p.copy_(start[n])
    del start
    step_fn = make_train_step(cfg32, opt)
    batch = {"tokens": torch.as_tensor(ptoks[:2], device=dev0)}
    state = adamw.init_state(p32, opt)
    state, _ = step_fn(state, batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as tmp:
        t0 = time.perf_counter()
        ck = CK.AsyncCheckpointer(tmp)
        ck.save(state, int(state.step))
        t_snap = time.perf_counter() - t0
        ck.wait()
        t_save = time.perf_counter() - t0
        fresh = adamw.init_state(
            T.init_params(cfg32, torch.Generator(dev0).manual_seed(1)), opt)
        t0 = time.perf_counter()
        fresh, step = CK.restore(fresh, tmp)
        t_restore = time.perf_counter() - t0
    check(step == 1 and int(fresh.step) == 1, f"ckpt: restored step {step}")
    _, m1 = step_fn(state, batch)
    _, m2 = step_fn(fresh, batch)
    check(float(m1["loss"]) == float(m2["loss"]),
          f"ckpt: loss {float(m1['loss'])} after restore, "
          f"{float(m2['loss'])} without")
    log(f"ckpt: {n_par}-layer float32 state saved (snapshot "
        f"{t_snap:.2f} s, written {t_save:.2f} s), restored in "
        f"{t_restore:.2f} s; the next step's loss {float(m1['loss']):.6f}"
        f" equal on both")
    del state, fresh, p32
    torch.cuda.empty_cache()


def hgmma_counts(lib_path):
    """The SASS of the kernels' library (``cuobjdump -sass``): HGMMA
    instructions by kernel name, or None where the toolkit has no
    cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and fn:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def attn_bwd_check(torch, randn, B, S, h, kh, d, dtype, timed=False):
    """Hold ``flash_attention_bwd``, fed the log-sum-exp the forward
    keeps, against ``attention_bwd_ref`` on inputs from ``randn`` at
    ``ATTN_BWD_TOL``, two calls bitwise equal and equal to a call that
    has the forward write the log-sum-exp again; with ``timed``, time
    kernel, plain version and SDPA's backward and return the
    measurements for a kernel record."""
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    F = torch.nn.functional
    q, k, v = (randn(s, dtype) for s in ((B, S, h, d), (B, S, kh, d),
                                         (B, S, kh, d)))
    # the forward as training runs it: the output and each row's
    # log-sum-exp, which the backward reads
    out, lse = KA.flash_attention_fwd(q, k, v, keep_lse=True)
    dout = randn((B, S, h, d), dtype)
    got = KA.flash_attention_bwd(q, k, v, out, dout, lse)
    again = KA.flash_attention_bwd(q, k, v, out, dout, lse)
    fresh = KA.flash_attention_bwd(q, k, v, out, dout)  # writes it again
    want = RA.attention_bwd_ref(q, k, v, out, dout)
    tol = ATTN_BWD_TOL[str(dtype).split(".")[-1]]
    err = 0.0
    shape = f"B={B} S={S} H={h} KH={kh} D={d} {dtype}"
    for name, g, a, f, w in zip(("dq", "dk", "dv"), got, again, fresh,
                                want):
        check(torch.equal(g, a), f"flash_attention_bwd {shape}: {name} "
                                 f"differs between two calls")
        check(torch.equal(g, f), f"flash_attention_bwd {shape}: {name} "
                                 f"differs with the log-sum-exp "
                                 f"written again")
        e = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        check(e <= tol * top, f"flash_attention_bwd {shape}: {name} "
                              f"max |err| {e:.3g} above {tol} x "
                              f"{top:.3g}")
        err = max(err, e)
    log(f"  flash_attention_bwd {shape}: max abs err {err:.3g}, two "
        f"calls and the log-sum-exp written again bitwise equal")
    res = None
    if timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dlib = dout.transpose(1, 2).contiguous()
        elt = q.element_size()
        res = dict(
            err=err, shape=shape,
            ms=cuda_ms(lambda: KA.flash_attention_bwd(q, k, v, out,
                                                      dout, lse), torch),
            plain_ms=cuda_ms(lambda: RA.attention_bwd_ref(q, k, v, out,
                                                          dout),
                             torch, 2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dlib, retain_graph=True), torch),
            nbytes=elt * (4 * B * S * h * d + 4 * B * S * kh * d),
            ops=5.0 * B * h * d * S * S,
            ops_per_s=BF16_OPS_S if dtype == torch.bfloat16
            else FP32_OPS_S)
        log(f"  timed {shape}: kernel {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, SDPA backward "
            f"{res['library_ms']:.3f} ms, kernel/SDPA "
            f"{res['ms'] / res['library_ms']:.2f}")
        del qt, kt, vt, lib_out, dlib
    del q, k, v, out, lse, dout, got, again, fresh, want
    torch.cuda.empty_cache()
    return res


def attention_bwd_phase(args, torch, dev0, record):
    """14. The backward kernel against its plain version at the training
    packet and other shapes, bitwise-equal across calls and with the
    log-sum-exp kept by the forward or written again; its bfloat16 kernels
    on wgmma (HGMMA in their SASS); kernel, plain version and SDPA's
    backward timed beside the bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    cfg = get_config("llama3.2-1b")
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen_t = torch.Generator(dev0).manual_seed(4)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    counts = hgmma_counts(build.load()._name)
    if counts is None:
        log("flash_attention_bwd SASS: no cuobjdump in the toolkit")
    else:
        bwd_mma = {k: n for k, n in counts.items() if "bwd_" in k}
        log("flash_attention_bwd SASS: HGMMA instructions " + ", ".join(
            f"{n} in {k[:60]}" for k, n in sorted(bwd_mma.items())))
        check(len(bwd_mma) == 6, f"flash_attention_bwd: HGMMA in "
                                 f"{sorted(bwd_mma)}, expected the dK/dV "
                                 f"and dQ kernels at D = 64, 80, 128")
    log("flash_attention_bwd against its plain version:")

    def bwd(*shape, timed=False):
        return attn_bwd_check(torch, randn, *shape, timed=timed)

    packet = bwd(1, TRAIN["seq"], H, KH, D, bf16, timed=True)
    bwd(2, 1000, H, KH, D, bf16)            # ragged S
    bwd(1, 1000, H, KH, D, f32)
    bwd(2, 256, 8, 4, 80, f32)              # stablelm-3b's head dim
    bwd(2, 256, 8, 4, 80, bf16)
    bwd(1, 384, 16, 2, 128, f32)            # qwen3-32b's head dim
    bwd(1, 384, 16, 2, 128, bf16)
    # the wgmma kernels' edges, as tests/test_torch_cuda.py covers them:
    # G = 1, 4, 6 (idle packed rows), 8; S = 2, below a 64-row step, below
    # a 128-key tile, ragged.  (At S = 1 dq and dk are exactly zero, so no
    # share of their largest |value| bounds the rounding: the card tests
    # hold that case with an absolute floor.)
    for B, S, h, kh, d in ((2, 2, 8, 8, 64), (2, 50, 24, 4, 80),
                           (1, 127, 16, 2, 128), (2, 129, 8, 2, 64),
                           (1, 1000, 12, 2, 128), (1, 333, 32, 4, 80)):
        bwd(B, S, h, kh, d, bf16)
    record("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
           "src/repro/kernels/flash_attention/kernel.py:69",
           packet["err"], packet["ms"], packet["plain_ms"], packet["nbytes"],
           packet["ops"], packet["library_ms"],
           packet["shape"] + " (training packet of one row)",
           packet["ops_per_s"],
           replaces_note="the gradient of that kernel's function: the JAX "
                         "package differentiates its jnp attention "
                         "(src/repro/models/layers.py:73, :123) with "
                         "jax.value_and_grad",
           library_note="torch.autograd.grad through one "
                        "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), the backward alone")


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


def suite_phases(args, torch, dev0, attach, host_runs):
    """The whole program suite on ``[cuda:0, cpu]``, the paper's two
    offloading modes, a journaled run resumed, and the autotuner.  Each
    suite run's host packets go into ``host_runs`` for phase 5f."""
    import tempfile

    from repro_torch.api import (EngineSession, OffloadMode, Region,
                                 RunJournal, coexec, resume_run)
    from repro_torch.core import programs as P
    from repro_torch.kernels.gaussian import kernel as KG, ops as gops
    from repro_torch.kernels.gaussian import ref as RG
    from repro_torch.kernels.mandelbrot import kernel as KM, ref as RM
    from repro_torch.kernels.ray import ops as RO
    from repro_torch.tune import TuneCache, autotune

    sizes = SMALL_SUITE_SIZES if args.small else SUITE_SIZES
    counters = {"gaussian": KG, "mandelbrot": KM}
    uses = {"gaussian2d": "gaussian", "mandelbrot2d": "mandelbrot"}
    # the module whose host routine each program's host group runs
    host_mod = {"gaussian2d": KG, "mandelbrot2d": KM}
    launches2d, powers_of, refs = {}, {}, {}

    # -------------------------------------------- the whole program suite
    for name, kw in sizes.items():
        t0 = time.perf_counter()
        prog = P.PROGRAMS[name](**kw)
        devices = fleet()
        powers = powers_of[name] = probe(prog, devices)
        setup_s = time.perf_counter() - t0
        hm = host_mod.get(name, RO)
        for k in (*counters.values(), hm):
            k.launches = 0
            k.host_calls = 0
        t0 = time.perf_counter()
        res = coexec(prog, devices, powers=powers)
        wall = time.perf_counter() - t0
        counts = {k: m.launches for k, m in counters.items()}
        host_calls = hm.host_calls
        check_card_group(res, devices, name)
        check_host_group(res, host_calls, name)
        host_runs[name] = host_run(res, kw, host_calls)
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
            f"{len(res.packets) - n_gpu}, launches {counts}, host calls "
            f"{host_calls}, busy s cuda0/cpu {res.device_busy[0]:.3f}/"
            f"{res.device_busy[1]:.3f}, max |out - ref| {err:.3g}, "
            f"flipped pixels {flips}")

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
                    counters[uses[name]].host_calls = 0
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
                    check_host_group(res, counters[uses[name]].host_calls,
                                     f"{name} {mode}")
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


# ------------------------------------------- host routines (phase 5f)
# each host routine: its source, the JAX package's jax.jit entries it
# stands for, and the programs whose host packets it ran
HOST_ROUTINES = {
    "mandelbrot": ("src/repro_torch/csrc/host/mandelbrot.cpp",
                   "src/repro/kernels/mandelbrot/ops.py:20,38",
                   ("mandelbrot", "mandelbrot2d")),
    "gaussian": ("src/repro_torch/csrc/host/gaussian.cpp",
                 "src/repro/kernels/gaussian/ops.py:29,60",
                 ("gaussian", "gaussian2d")),
    "binomial": ("src/repro_torch/csrc/host/binomial.cpp",
                 "src/repro/kernels/binomial/ops.py:27", ("binomial",)),
    "nbody": ("src/repro_torch/csrc/host/nbody.cpp",
              "src/repro/kernels/nbody/ops.py:25", ("nbody",)),
    "ray": ("src/repro_torch/csrc/host/ray.cpp",
            "src/repro/kernels/ray/ops.py:15,29",
            ("ray1", "ray2", "ray1_2d", "ray2_2d")),
}
# the most work-groups of a host packet held against the plain version,
# which redoes the routine's work in eager tensor ops: one for Mandelbrot,
# whose work-group of 8 rows x 14,336 px at 5,000 iterations takes the
# plain version seconds
HOST_CHECK_WG = {"mandelbrot": 1, "mandelbrot2d": 1, "binomial": 8}
HOST_CHECK_WG_DEFAULT = 4
HOST_REPS = 3


def host_cpu():
    """(model, logical CPUs) of the host, from ``lscpu``; where it names
    no model, its vendor, family and model numbers."""
    import os
    import platform
    info = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             check=True).stdout
        info = dict((k.strip(), v.strip()) for k, v in (
            line.split(":", 1) for line in out.splitlines() if ":" in line))
    except (OSError, subprocess.CalledProcessError):
        pass
    model = info.get("Model name", "")
    if model in ("", "unknown"):
        model = (f"{model or 'unnamed'} ({info.get('Vendor ID', '?')} "
                 f"family {info.get('CPU family', '?')} model "
                 f"{info.get('Model', '?')}, {platform.machine()})")
    return model, int(info.get("CPU(s)") or os.cpu_count() or 0)


def host_ms(fn, reps: int = HOST_REPS) -> float:
    """Mean wall time of ``fn`` (a host call, synchronous) over ``reps``
    calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def readback_s(torch, dev0, n_elem: int, dtype) -> float:
    """Seconds to bring ``n_elem`` card elements of ``dtype`` to the host
    as the runtime's commit does: ``.cpu().numpy()`` and a copy into a
    host array."""
    x = torch.zeros(n_elem, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, device=dev0)
    out = np.empty(n_elem, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out[:] = x.detach().cpu().numpy()
    dt = time.perf_counter() - t0
    del x
    return dt


def host_cases(name, kw, torch):
    """(host, plain) of program ``name`` on the host: ``host(off, n)``
    runs the program's range entry (its host routine) on dim-0 units
    [off, off + n) (work-groups of a 1-D program, rows of a 2-D one),
    ``plain(off, n)`` the plain version on the same inputs."""
    from repro_torch.kernels.binomial import ops as bops, ref as RB
    from repro_torch.kernels.gaussian import ops as gops, ref as RG
    from repro_torch.kernels.mandelbrot import ops as mops, ref as RM
    from repro_torch.kernels.nbody import ops as nops, ref as RN
    from repro_torch.kernels.ray import ops as rops, ref as RR

    if name.startswith("gaussian"):
        img = np.random.default_rng(0).standard_normal(
            (kw["h"], kw["w"])).astype(np.float32)
        ip, w = (torch.from_numpy(x) for x in gops.prepare(img))
        if name == "gaussian":
            return (lambda o, n: gops.run_range(ip, w, o, n),
                    lambda o, n: RG.blur_rows_ref(ip, w, o * gops.LWS,
                                                  n * gops.LWS))
        return (lambda o, n: gops.run_region(ip, w, o, n, 0, kw["w"]),
                lambda o, n: RG.blur_rows_ref(ip, w, o, n))
    if name.startswith("mandelbrot"):
        px, it = kw["px"], kw["max_iter"]
        if name == "mandelbrot":
            return (lambda o, n: mops.run_range(o, n, width=px, height=px,
                                                max_iter=it, device="cpu"),
                    lambda o, n: RM.escape_counts(o * mops.LWS,
                                                  n * mops.LWS, px, px, it))
        return (lambda o, n: mops.run_region(o, n, 0, px, width=px,
                                             height=px, max_iter=it,
                                             device="cpu"),
                lambda o, n: RM.escape_counts(o, n, px, px, it))
    if name == "binomial":
        s0, k0, ty = (torch.from_numpy(x)
                      for x in bops.make_inputs(kw["n_options"]))
        L = bops.LWS
        return (lambda o, n: bops.run_range(s0, k0, ty, o, n),
                lambda o, n: RB.price_options(s0[o * L:(o + n) * L],
                                              k0[o * L:(o + n) * L],
                                              ty[o * L:(o + n) * L]))
    if name == "nbody":
        pm, vel = (torch.from_numpy(x)
                   for x in nops.make_inputs(kw["n_bodies"]))
        return (lambda o, n: nops.run_range(pm, vel, o, n),
                lambda o, n: RN.step_rows(pm, vel, o * nops.LWS,
                                          n * nops.LWS))
    px = kw["px"]
    scene = {k: torch.from_numpy(v)
             for k, v in RR.make_scene(int(name[3])).items()}
    ax = {k: torch.from_numpy(v) for k, v in RR.pixel_axes(px, px).items()}
    if name.endswith("_2d"):
        return (lambda o, n: rops.run_region(scene, o, n, 0, px, width=px,
                                             height=px, axes=ax),
                lambda o, n: RR.render_rows(scene, o, n, px, px, 0, px, ax))
    return (lambda o, n: rops.run_range(scene, o, n, width=px, height=px,
                                        axes=ax),
            lambda o, n: RR.render_rows(scene, o * rops.LWS, n * rops.LWS,
                                        px, px, 0, px, ax))


def host_phase(args, torch, dev0, attach, host_runs, build_s):
    """Phase 5f: each host routine against its plain version on the host
    at the host group's largest packet of phases 3 and 5a (one work-group
    in the middle of the range where the host ran none), capped at
    ``HOST_CHECK_WG`` work-groups for the comparison; host routine and
    plain version timed; a ``host`` entry for each routine."""
    from repro_torch.core import programs as P
    from repro_torch.kernels.nbody import kernel as KN, ops as nops
    from repro_torch.kernels.nbody import ref as RN

    model, cores = host_cpu()
    threads = torch.get_num_threads()
    log(f"host CPU: {model}, {cores} logical CPUs, torch threads {threads};"
        f" host library build {build_s[0]:.2f} s wall (g++ "
        f"{build_s[1]:.2f} s)")
    entries = {}
    for routine, (src, replaces, programs) in HOST_ROUTINES.items():
        cases = []
        for name in programs:
            run = host_runs[name]
            kw = run["kw"]
            host, plain = host_cases(name, kw, torch)
            # dim-0 units a work-group: 1 (1-D) or the 2-D program's lws
            prog = P.PROGRAMS[name](**kw)
            region = prog.work_region.dims[0]
            wg = region.lws
            if run["packets"]:
                off, size = max(run["packets"], key=lambda p: p[1])
                where = "the host group's largest packet"
            else:
                size = wg
                off = region.offset + (region.size // 2) // wg * wg
                where = "one work-group (the host group ran no packet)"
            n = min(size, HOST_CHECK_WG.get(name, HOST_CHECK_WG_DEFAULT) * wg)
            t0 = time.perf_counter()
            want = plain(off, n)
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = host(off, n)
            got_np, want_np = got.numpy(), want.reshape(got.shape).numpy()
            if routine == "ray":
                err, _ = compare_output(name, got_np.reshape(-1, 3),
                                        want_np.reshape(-1, 3))
            elif routine == "mandelbrot":
                err, _ = compare_output(name, got_np, want_np)
            else:
                rtol, atol = TOLERANCES[routine]
                np.testing.assert_allclose(got_np, want_np, rtol=rtol,
                                           atol=atol, err_msg=name)
                err = float(np.abs(got_np.astype(np.float64)
                                   - want_np).max())
            ms = host_ms(lambda: host(off, n))
            packet_ms = ms if n == size else host_ms(lambda: host(off, size))
            case = dict(program=name, packet=[off, size], where=where,
                        checked=[off, n], host_packets=len(run["packets"]),
                        host_calls=run["host_calls"],
                        host_busy_s=run["busy_s"], roi_s=run["roi_s"],
                        ms=ms, plain_ms=plain_ms, packet_ms=packet_ms,
                        max_abs_err=err)
            log(f"host {routine} on {name} {kw}: units [{off}, {off + n}) "
                f"of {where} [{off}, {off + size}): {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x), whole packet "
                f"{packet_ms:.4f} ms, max abs err {err:.3g}; main path: "
                f"{len(run['packets'])} host packets, {run['host_calls']} "
                f"host calls, host busy {run['busy_s']:.3f} s of the "
                f"{run['roi_s']:.3f} s ROI")
            if prog.work_region.ndim == 1:
                # what the runtime's commit does with the card's rows (a
                # read-back into pageable memory and a copy into the
                # output), once for all of them, on the card's thread's
                # clock (not part of the card's busy time)
                case["card_readback_s"] = readback_s(
                    torch, dev0, run["card_units"] * prog.out_rows_per_wg
                    * prog.out_cols, prog.out_dtype)
                log(f"  the card's {run['card_units']} work-groups of "
                    f"{name} read back and copied: "
                    f"{case['card_readback_s']:.3f} s")
            cases.append(case)
        entries[routine] = dict(source=src, replaces=replaces, cpu=model,
                                cores=cores, threads=threads, cases=cases)

    # nbody on the host against float64 at the main path's size, as phase
    # 5 measures the card's kernel
    kw = host_runs["nbody"]["kw"]
    pm_np, vel_np = nops.make_inputs(kw["n_bodies"])
    pm, vel = torch.from_numpy(pm_np), torch.from_numpy(vel_np)
    pkts = host_runs["nbody"]["packets"]
    t0n = max(pkts, key=lambda p: p[1])[0] * nops.LWS if pkts else 0
    nt = min(256, pm.shape[0] - t0n)
    acc64 = RN.accelerations(pm.double().to(dev0), t0n, nt).cpu()
    rel = {}
    for label, rows in (("host", KN.step_rows(pm, vel, t0n, nt)),
                        ("plain", RN.step_rows(pm, vel, t0n, nt))):
        acc = (rows[:, 4:7].double() - vel[t0n:t0n + nt].double()) / RN.DT
        rel[label] = float(((acc - acc64).norm(dim=1)
                            / acc64.norm(dim=1)).max())
    log(f"  nbody |acc - acc_f64| / |acc_f64| over {nt} targets from "
        f"{t0n} on the host: host routine {rel['host']:.3g}, plain "
        f"{rel['plain']:.3g} (the card's kernel at most {NBODY_F64_REL})")
    entries["nbody"]["f64_rel"] = rel["host"]
    entries["nbody"]["plain_f64_rel"] = rel["plain"]
    del acc64
    torch.cuda.empty_cache()

    for routine in ("mandelbrot", "gaussian", "binomial", "nbody"):
        attach(routine, host=entries[routine])
    return dict(cpu=model, cores=cores, threads=threads,
                build_s=build_s[0], gxx_s=build_s[1], ray=entries["ray"])


def device_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small sizes instead of the paper's")
    ap.add_argument("--phase", choices=["fleet"],
                    help="build, then run this phase alone (a quicker "
                         "check; prints no kernels line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.api import EngineSession, OffloadMode, Region, coexec
        from repro_torch.core import programs as P
        from repro_torch.kernels import build, host_build
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
    t0 = time.perf_counter()
    host_build.load()
    host_build_s = (time.perf_counter() - t0, host_build.build_seconds)
    log(f"host build: {host_build_s[0]:.2f} s wall (g++ "
        f"{host_build_s[1]:.2f} s)")

    if args.phase == "fleet":
        paths = {}
        fleet_phase(args, torch, dev0, paths)
        log(f"fleet launches: {json.dumps(paths)}")
        print(smi)
        print(device_line(torch))
        return 0

    sizes = SMALL_SIZES if args.small else PAPER_SIZES
    kernels = {"gaussian": KG, "binomial": KB, "mandelbrot": KM,
               "nbody": KN}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0
            k.host_calls = 0

    def check_group(res, devices, name, used):
        check_card_group(res, devices, name)
        for k in used:
            check(kernels[k].launches > 0, f"{name}: {k} kernel unused")
            check_host_group(res, kernels[k].host_calls, name)

    # ----------------------------------------------------- main path
    launches, largest, smallest = {}, {}, {}
    outputs, host_runs = {}, {}
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
        host_calls = kernels[name].host_calls
        check_group(res, devices, name, [name])
        launches[name] = counts[name]
        host_runs[name] = host_run(res, kw, host_calls)
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
            f"launches {counts}, host calls {host_calls}, busy s cuda0/cpu "
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
            n_launch, n_host = KB.launches, KB.host_calls
            check_group(res, devices, "binomial ROI", ["binomial"])
            want = outputs["binomial"][off * 128:(off + size) * 128]
            np.testing.assert_allclose(res.output, want, rtol=1e-4,
                                       atol=1e-3)
            log(f"ROI binomial [{off}, {off + size}) of {G}: roi "
                f"{res.total_time:.3f} s, init {res.phases.init_s:.4f} s, "
                f"launches {n_launch}, host calls {n_host}")

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

    suite_phases(args, torch, dev0, attach, host_runs)
    host_info = host_phase(args, torch, dev0, attach, host_runs,
                           host_build_s)
    serving_phases(args, torch, dev0, launches, record)
    paths = {}
    fleet_phase(args, torch, dev0, paths)
    mamba_phases(args, torch, dev0, launches, record)
    training_phases(args, torch, dev0, launches, attach)
    attention_bwd_phase(args, torch, dev0, record)
    mla_phases(args, torch, dev0, record)
    paths["jamba-v0.1-52b"], jamba_a, jamba_d = jamba_phases(args, torch,
                                                             dev0)
    paths["internvl2-1b"], g7_a, g7_d = vlm_phase(args, torch, dev0)
    paths["musicgen-large"], mg_a, mg_d = audio_phase(args, torch, dev0)
    # phases 8a and 18-21 add their paths' launches to the three kernels'
    # records
    for rec in records:
        if rec["name"] not in SERVED_KERNELS:
            continue
        by = {SERVED_KERNELS[rec["name"]]: rec["launches"]}
        by.update((m, c[rec["name"]]) for m, c in paths.items()
                  if c.get(rec["name"]))
        rec.update(launches=sum(by.values()), launches_by_path=by)
    for name, g7, jamba, mg in (("flash_attention", g7_a, jamba_a, mg_a),
                                ("flash_decode", g7_d, jamba_d, mg_d)):
        attach(name, g7_shape=long_entry(g7, "G = 7 (internvl2-1b)"),
               jamba_shape=long_entry(jamba, "jamba-v0.1-52b's heads"),
               musicgen_shape=long_entry(mg, "musicgen-large's heads"))

    # phases 22-25: training of the Mamba, hybrid, MoE and frontend
    # families, through the scan's backward kernel
    scan_bwd = scan_bwd_phase(args, torch, dev0)
    trained = {}
    trained["jamba-v0.1-52b"], jamba_b = jamba_train_phases(args, torch,
                                                            dev0)
    trained["falcon-mamba-7b"] = falcon_train_phase(args, torch, dev0)
    front, front_b = frontend_train_phase(args, torch, dev0)
    trained.update(front)
    by_path = {k: {f"{m} training": t["launches"][k]
                   for m, t in trained.items() if t["launches"][k]}
               for k in train_kernels()}
    record("selective_scan_bwd", "src/repro_torch/csrc/selective_scan.cu",
           "src/repro/kernels/mamba_scan/kernel.py:55", scan_bwd["err"],
           scan_bwd["ms"], scan_bwd["plain_ms"], scan_bwd["nbytes"],
           scan_bwd["ops"], None, scan_bwd["shape"] + " (training packet)",
           n_launches=sum(by_path["selective_scan_bwd"].values()),
           launches_by_path=by_path["selective_scan_bwd"],
           replaces_note="the gradient of that kernel's function: the JAX "
                         "package differentiates its jnp scan "
                         "(src/repro/models/layers.py:559 "
                         "_ssm_scan_chunked) with jax.value_and_grad",
           library_note="no single PyTorch call computes this recurrence "
                        "or its gradient")
    # the training paths' launches join the other kernels' records
    for rec in records:
        extra = by_path.get(rec["name"])
        if not extra or rec["name"] == "selective_scan_bwd":
            continue
        by = rec.get("launches_by_path") or {
            ("llama3.2-1b training" if rec["name"] == "flash_attention_bwd"
             else SERVED_KERNELS[rec["name"]]): rec["launches"]}
        by.update(extra)
        rec.update(launches=sum(by.values()), launches_by_path=by)
    attach("flash_attention_bwd",
           jamba_shape=long_entry(jamba_b, "jamba-v0.1-52b's heads"),
           g7_shape=long_entry(front_b["internvl2-1b"],
                               "G = 7 (internvl2-1b)"),
           musicgen_shape=long_entry(front_b["musicgen-large"],
                                     "musicgen-large's heads"))
    log("training table: " + json.dumps(
        {m: {k: t[k] for k in ("step_s", "tokens_s", "busy", "peak_gb")}
         for m, t in trained.items()}))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"the port imported {leaked}")

    print(json.dumps({"kernels": records, "host": host_info}))
    print(smi)
    print(device_line(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
