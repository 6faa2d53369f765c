#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                # the paper's sizes, one card
    python3 chip_smoke.py --small        # small sizes: a quick build-and-run
    python3 chip_smoke.py --phase fleet  # the build and phase 8a alone
    python3 chip_smoke.py --phase plan   # the build and phases 26-30 alone
    python3 chip_smoke.py --phase served # the build and phases 31-34 alone
    python3 chip_smoke.py --phase sharded  # the build and phases 35-37 alone
    python3 chip_smoke.py --phase trained  # the build and phases 38-41 alone
    python3 chip_smoke.py --phase sharded_train  # build, phases 42-43
    python3 chip_smoke.py --phase kvseq  # the build and phases 44-46 alone
    python3 chip_smoke.py --phase data   # the build and phases 47-49 alone

The whole script must finish within 1,000 s of command time on one H100
from a clean checkout, builds included (``PERF.md`` has each run's);
phase 26's planning of every cell runs from phase 6 on beside the card
phases, in processes at the lowest priority, and phase 26 only waits for
it.  ``--phase fleet`` builds the kernels and runs phase 8a alone,
``--phase plan`` phases 26-30 (about 2.5 minutes, the planning in the
foreground), ``--phase served`` phases 31-34 and ``--phase sharded``
phases 35-37 (about 2.5 minutes with the build), ``--phase trained``
phases 38-41, ``--phase sharded_train`` phases 42-43, ``--phase
kvseq`` phases 44-46 and ``--phase data`` phases 47-49 (llama3.2-1b
trained on all 16 layers, about 6 minutes), printing no kernels line.
Each phase group's start is logged with the seconds since the script
started.

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the eleven CUDA kernels from ``src/repro_torch/csrc`` (timed as
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
9. serve falcon-mamba-7b at full width on 16 of its 64 layers
   (``MAMBA_SERVED_LAYERS``; ``--small``: 2) in bfloat16 with the set-up
   of phase 6.  All must be served; the launch
   counters, set to 0 after a warm-up, must show one
   ``selective_scan_fused`` launch per layer and prefill, none of the (a,
   b, C) form, and none in a decode step (one recurrence step in plain
   ops); a fresh replica must give the same tokens.  Prefill and
   decode-step times from CUDA events, beside the weight-read bound, and
   a profile of each; no op of a traced prefill may read a (B, S, d_inner,
   d_state) plane (``torch.profiler``'s input shapes);
10. card against host as phase 7, on the first 8 of its 64 layers (a cut
    of depth that bounds the host's memory and time; full width);
11. hold ``selective_scan`` against its plain version at the serving
    shape, a long shape and a ragged one with a carried state (rtol 1e-4 /
    atol 1e-5), and time kernel and plain version; no single PyTorch call
    computes this recurrence, so it has no library time; hold
    ``selective_scan_fused`` (the discretisation inside the kernel: dt and
    x in bfloat16) against its plain version at the same tolerance at the
    serving shape (B=4 S=256 di=8192 ds=16) and a long shape (B=2 S=4096),
    both timed beside the bound on dt, x, A, B, C and y, at a rank's share
    (di 2048, timed in phase 37), a ragged S with an odd di (bfloat16 rows
    staged by loads) and a carried state, and float32 inputs; then the
    (a, b, C) form's own path, the port's scan op
    (``kernels/mamba_scan/ops.py`` ``selective_scan``) under autograd at
    the serving shape: one forward and one backward launch, counted from
    0, finite gradients (the records of ``selective_scan`` and
    ``selective_scan_bwd`` count this path);
12. train llama3.2-1b at full width (``--small``: 2 of its 16 layers) in
    bfloat16 through ``HeteroDPTrainer``: two groups on ``cuda:0``
    (throttles 1 and 2) sharing one copy of the weights, random weights
    from seed 0, ``SyntheticPipeline`` (seed 1234) at TRAIN_4K's 4,096
    tokens, a global batch of 8 (TRAIN_4K's 256 cut to 8), lws 1, AdamW
    (lr 1e-3, warm-up 1, 8 total steps), 6 steps.  Every loss finite,
    8 x 4,096 tokens a step, the last loss below the first, rows on both
    groups; the launch counters, set to 0 before each step, must show 44
    ``flash_attention`` launches (the forward and the rematerialised
    recomputes: 4 remat groups of 4 layers, 3 runs of each layer but
    for a group's last, which runs twice: ``T.forward_runs``) and 16
    ``flash_attention_bwd`` calls per packet.  Step time, tokens/s,
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
    ``wgmma`` at D = 64, 80, 128 and 192, and the forward at (D, Dv) =
    (64, 64), (80, 80), (128, 128), (192, 128) and (192, 192) (HGMMA in
    their SASS, ``cuobjdump``); hold
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
15. hold ``flash_attention`` at MLA's widths (deepseek-v2-lite-16b: q
    and k at 192 = 128 nope + 64 rope columns, v at 128, H = KH = 16)
    against its plain version at the MLA prefill shape (B=4, S=256), the
    long shape (B=1, S=4096; ``--small``: 1024), ragged S (1000, 127,
    129), G = 2 and 3, bfloat16 at 2e-2 and float32 at rtol 1e-4 / atol
    2e-5, its kept log-sum-exp against ``attention_lse_ref``; time kernel,
    plain version and SDPA at the prefill and the long shape (the
    ``flash_attention_d192`` record), SDPA on v zero-padded to 192 and on
    v at 128, each with the backend it took, the faster the yardstick;
    hold and time the equal-width instance (v of 192 columns) at the
    prefill shape;
16. serve deepseek-v2-lite-16b at full width on 7 of its 27 layers
    (``MLA_SERVED_LAYERS``: the dense one and 6 MoE; ``--small``: 2, the
    dense one and one MoE layer) in bfloat16 with the set-up of phase 6.  All must be served; the launch counters, set to 0 after
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
    jamba-v0.1-52b at full width on 8 of its 32 layers (one period of
    8: 26.6 GB of bfloat16 weights; ``--small``: one period of 4,
    ``attn_every`` 4 at offset 2, the smoke config's period) with the
    set-up of phase 6.  All must be served; the launch counters, set to 0
    after a warm-up, must show one ``flash_attention`` launch per
    attention layer (1) and one ``selective_scan_fused`` launch per Mamba
    layer (7) a prefill, none of the (a, b, C) form, one ``flash_decode``
    launch per attention layer and no scan a decode step; a fresh
    replica must give the same tokens.  Prefill and decode-step times
    beside the weight-read bound (the capacity dispatch runs all 16
    experts), a profile of each, peak memory and each replica group's
    busy time;
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
    two calls bitwise equal; then ``selective_scan_fused_bwd``, fed the
    states the fused forward keeps, against
    ``selective_scan_fused_bwd_ref`` likewise, at the training packet in
    bfloat16 (timed), at a rank's training share (B=1 S=2048 di=2048,
    timed in phase 43), at the same edges in float32 and at an odd di in
    bfloat16 (d_dt and d_x in bfloat16 also within one bfloat16 step);
23. hold ``flash_attention_bwd`` at jamba's heads (32/8, D = 128; timed
    at S=4096 with SDPA's backward); train jamba-v0.1-52b at full width
    on 2 layers (attention + MoE, Mamba + MLP: 3.68 B parameters) in
    bfloat16 through ``HeteroDPTrainer`` with phase 12's set-up, a global
    batch of 4 x 4,096 tokens where ``launch.dryrun``'s plan of a one-row
    packet, times the allocator's measured reserve over it, says two
    groups fit under ``PLAN_FILL`` of the card, else (as now) 4 x 2,048
    (``--small``: 2 x 1,024), 4 steps: every loss finite, the
    objective on a held-out batch lower after the steps than before
    them (each step's loss is on its own tokens), rows on both groups,
    and per packet 2 ``flash_attention``, 1 ``flash_attention_bwd``, 2
    ``selective_scan_fused`` and 1 ``selective_scan_fused_bwd`` launches
    and none of the (a, b, C) form (counters set to 0 before each step);
    step time, tokens/s, peak memory and a profile of one more step;
24. card against host in float32 (TF32 off) on those 2 layers, batch 1
    x 256: the loss within 1e-4 relative, every gradient within 1e-3 of
    its parameter's largest |g|, every token routed to the same experts
    on both sides and in the rematerialised recompute as in the forward
    (the smallest top-2 margin logged); falcon-mamba-7b on 8 of its 64
    layers (``--small``: 2), 2 ``make_train_step`` steps of batch 2 x
    4,096: finite losses and gradient norms, the fused scan's launches of
    ``T.forward_runs`` (2 remat groups of 4 layers: 22) and 1 fused
    backward launch a layer, none of the (a, b, C) form; no op of one
    traced step may read a (B, S, d_inner, d_state) plane; card against
    host on its first 2 layers;
25. hold ``flash_attention_bwd`` at internvl2-1b's G = 7 (14/2, D = 64)
    and musicgen-large's 32/32 heads (D = 64), timed at S=4096 with SDPA's
    backward, and at ragged S in both dtypes; train internvl2-1b (24
    layers, 256 patches a row) and musicgen-large (8 of 48 layers, (B,
    S, 4) tokens; ``--small``: 2 layers each) 3 steps each through
    ``HeteroDPTrainer`` with the launch counts of phase 23 and finite
    losses; card against host in float32 on 2 layers of each (internvl2-
    1b with 256 patch positions, which the loss leaves out; musicgen's
    loss averaged over its codebooks);
26. plan every arch x shape cell of ``launch.dryrun`` on one card (1, 1)
    and four (1, 4) in ``PLAN_BACKGROUND_WORKERS`` processes on the host
    at nice 19 (each cell's step on the ``meta`` device, and on (1, 4)
    rank 0's step, a train cell's too), started after phase 5f: per-device
    argument bytes, predicted peak and flops logged;
27. hold llama3.2-1b's training cell (phase 12's 8 x 4,096 tokens, one
    row a microbatch) against its plan: the bytes the state and tokens
    ask of the caching allocator (``requested_bytes``) equal the planned
    argument bytes and ``memory_allocated`` their 512-byte rounding plus
    the allocator's unsplit remainders (at most 1 MiB a tensor); the
    peak of one ``make_train_step`` (``max_memory_allocated``) within
    ``PLAN_PEAK_TOL`` of the planned one; the plan's flops over each
    step's time over the card's 989e12 (the model-FLOP share);
28. hold ``flash_attention_bwd`` at MLA's head dim 192 against its plain
    version (bfloat16 at 2e-2, float32 at 1e-4 of each output's largest
    |value|; ragged S, G = 2), timed at B=1 S=4096 H=KH=16 beside SDPA's
    backward; the timed bfloat16 call's three kernels (D_i,
    ``bwd_dkdv_split_kernel<192>``, ``bwd_dq_wgmma_kernel<192>``: on
    ``wgmma``, no FMA kernel) each logged with its device time
    (``kernels_ms`` in the record); at that shape with v at 128, the
    gradients under autograd bitwise those of the backward on v, the
    output and its gradient zero-padded to 192, and the padding's cost
    timed (``v_width_ms`` against ``v_padded_ms``);
29. deepseek-v2-lite-16b at full width on its first 3 layers (the dense
    one and two MoE; 1.670 B parameters), its rows chosen by the plan
    (4 x 4,096 tokens unless two groups' packets would not fit): the
    plan held against one ``make_train_step`` as in 27, then trained in
    bfloat16 through ``HeteroDPTrainer`` as phase 23 (3 ``flash_attention``
    x 2 and 3 ``flash_attention_bwd`` launches a packet), each step's
    model-FLOP share logged;
30. card against host in float32 on its first 2 layers, batch 1 x 256,
    as phase 24, every token routed alike;
31. qwen3-32b (64/8 heads, G = 8, D = 128, q/k RMSNorm) at full width
    on 8 of its 64 layers (``SERVED_CONFIGS``; ``--small``: 2 layers):
    hold ``flash_attention`` at its serving prefill (B=4,
    S=256) and ``flash_decode`` at its serving decode (B=4, Smax=288,
    pos=287) in bfloat16 against their plain versions, timed (the
    ``qwen3_shape`` entries), and both at a ragged S in float32; serve it
    as phase 6 does (one ``flash_attention`` launch a layer and prefill,
    one ``flash_decode`` launch a layer and decode step, no other
    kernel); card against host in float32 on a model of its first 2
    layers made fresh from the cut config (the embedding and head of
    151,936 tokens included);
32. yi-9b (32/4, G = 8, D = 128) likewise, 12 of its 48 layers, card
    against host on 4 layers (``yi_shape``);
33. stablelm-3b (32/32, G = 1, D = 80) likewise, 8 of its 32 layers,
    card against host on 8 layers (``stablelm_shape``);
34. dbrx-132b (48/8, G = 6, D = 128; 16 experts, top 4, every layer) at
    full width on its first 2 of 40 layers (14.3 GB; the whole 263 GB
    does not fit one card; ``--small``: 2), as phase 31, its capacity
    dispatch running all 16 experts in a decode step; card against host
    on 2 layers (13 GB of float32 a layer) with every token routed to
    the same experts on both sides (``dbrx_shape``).  The four serving
    rows (served s, tokens/s, peak and weights GB, prefill and decode-step
    ms with their busy shares) are logged as one JSON line.
35. jamba-v0.1-52b split over four ranks on the card, the ("data",
    "model") = (1, 4) mesh (``parallel/spmd.py``, gloo: NCCL refuses two
    ranks on one GPU, and gloo gathers no CUDA tensor, so the logits'
    gather goes through host memory).  The parent builds the kernels;
    the ranks only load them.  One period of 4 (layers 0, 1, 4, 5 of the
    served model's kinds) in float32, 27.5 GB, runs on one process; each
    rank makes its blocks of the same weights (each layer drawn from a
    generator of its own, made whole in turn and cut by
    ``transformer.shard_params``: 6.9 GB a rank) and runs the same
    teacher-forced prefill and 4 decode steps; every rank's logits equal
    the one process's at rtol = atol = 2e-4, bitwise equal on the four
    ranks, with every token routed to the same experts;
36. one period of 4 of the 32 layers (attention at layer 2, three
    Mamba layers, MoE on two) at full width in bfloat16 (about a quarter
    of 13.8 GB a rank, never more than one whole layer on the card
    beside the blocks) served by the four ranks: batch 4, prompt 256, 16
    greedy tokens, the launches of each rank counted from 0 just before
    (1 ``flash_attention`` and 3 ``selective_scan_fused`` a prefill, none
    of the (a, b, C) form, 1 ``flash_decode`` a step), the
    tokens equal on every rank; per rank a prefill's and a decode step's
    time (CUDA events), its kernel time and busy share, peak memory, the
    collectives a step (``OpCost``) and the time in them (one rank set
    runs 35 and 36);
37. ``launch.dryrun.plan`` of the same cells on ``h100x4`` predicts
    phase 36's collectives kind by kind (count, result and wire bytes);
    its per-device peaks beside the measured one; ``flash_attention``,
    ``flash_decode``, ``selective_scan`` and ``selective_scan_fused`` held
    against their plain versions at a rank's shapes (8/2 heads,
    ``d_inner`` 2048) and timed
    (``sharded_shape`` of their records, whose ``launches_by_path`` gain
    phase 36's launches over the four ranks);
38-41. qwen3-32b, yi-9b, stablelm-3b and dbrx-132b trained at full width
    (``DENSE_TRAIN``; ``--small``: 2 layers at 1,024 tokens), one phase
    each: ``flash_attention`` at the config's heads (64/8, 32/4 and 48/8
    at D = 128, 32/32 at D = 80) against its plain version at B=1
    S=4096, ``flash_attention_bwd`` there too, timed beside SDPA's
    backward (``<config>_train_shape`` entries of its record), and at a
    ragged S; the depth (at most ``DENSE_TRAIN_MAX_LAYERS``) and the
    groups chosen by ``launch.dryrun.plan`` of a one-row packet under
    ``PLAN_FILL`` (``dense_train_plan``: the
    state, the bfloat16 sums of the gradients and one packet in flight
    on each group; two groups where any depth fits with two); that
    packet's plan held against the card as phase 27 holds llama's; then
    3 steps through ``HeteroDPTrainer`` of 4 x 4,096 tokens, bf16, AdamW
    with float32 moments at lr 1e-4, with phase 23's checks (launches a
    packet by ``T.forward_runs``, finite losses, a lower held-out
    objective) and
    its peak beside the planned one; qwen3, yi and stablelm then a
    float32 step of their first layer (qwen3) or 2 card against host, the
    gradients and one AdamW step (``check_updates``), dbrx the attention
    backward at 48/8 heads in float32 at a ragged S instead (the host
    cannot hold a float32 dbrx layer with its moments).  The four run on
    the allocator's expandable segments (``dense_train_phases``).  One
    "dense training table" JSON line.
42. jamba-v0.1-52b's 2-layer cut of phase 23 (attention + MoE, Mamba +
    MLP) at full width split over four gloo ranks on the card as phase
    35 splits it (8/2 heads, 4 of 16 experts, ``d_inner`` 2048, a
    quarter of the vocab), trained through ``make_train_step(res=...)``,
    whose collectives carry the gradients.  In float32 at 1 x 256 tokens
    each rank's loss (rtol 1e-5), every gradient of its blocks (within
    1e-4 of the whole gradient's largest |g|) and the gradients' norm
    (rtol 1e-4) against the one-process run of the whole model, which
    each rank runs in turn, every token routed alike;
43. bfloat16, 3 AdamW steps of one row of 2,048 tokens at lr 1e-3
    (``SHARDED_TRAIN_RUN``): each rank's launches a step
    (``per_packet``), losses equal on the four ranks, the held-out
    objective lower after, its step time, kernel time and busy share,
    its time in collectives, its peak within ``SHARDED_TRAIN_PEAK`` of
    the plan's rank-0 step (``launch.dryrun.plan`` on ``h100x4``) and
    its counted collectives equal to the plan's; then
    ``flash_attention``, ``selective_scan`` and ``selective_scan_fused``
    and their backwards held against their plain versions at a rank's
    shapes (B=1 S=2,048 8/2 heads of 128 in bfloat16; ``d_inner`` 2048,
    ``d_state`` 16) and timed, the attention's beside SDPA
    (``sharded_train_shape`` of their records, whose
    ``launches_by_path`` gain phase 43's launches);
44. ``flash_decode_partial`` (a rank's stretch of a cache split by
    positions: the live rows, a float32 output and each head's
    log-sum-exp from the kernel) at internvl2-1b's heads (B=4, 14/2,
    D=64) against its plain version, bfloat16 and float32, on a full, a
    partly live and an empty stretch of 72 rows (no launch: o 0, lse
    -inf) and on stretches of 8,192 that the kernel merges from several
    splits, o rounded to the cache's type bitwise ``flash_decode``'s;
    four stretches joined by ``ShardedRun.combine_lse`` in one process
    against ``flash_decode`` over the whole cache (one to three ranks
    empty); the kernel timed at the first stretch beside its bound and
    SDPA over the same rows (``kvseq_shape`` of ``flash_decode``'s
    record);
45. internvl2-1b (12 of its 24 layers) and deepseek-v2-lite-16b (its dense
    layer and one MoE layer) at full width in float32 on four gloo ranks
    of the card, whose caches the resolver splits by positions (each
    rank's stretch is checked to be a quarter of the cache of 96): a
    prompt of 64 (rank 3 empty) and 12 teacher-forced decode steps that
    cross into rank 3; the logits against the one-process run at rtol =
    atol = 2e-4, bitwise equal on the ranks, every routing equal;
46. internvl2-1b on 12 of 24 layers and deepseek-v2-lite-16b on 4 of 27
    layers at
    full width in bfloat16, 16 greedy tokens after a prompt of 208 into a
    cache of 288 (rank 3 empty until position 216): tokens equal on the
    ranks, each rank's launches (``flash_attention`` a layer at the
    prefill, ``flash_decode`` a GQA layer at each decode step whose
    position the rank's stretch has reached), a decode step's time, its
    share in gloo collectives and its peak within ``KVSEQ_PEAK`` of the
    plan's rank-0 step, and the plan's prefill and decode collectives
    equal to each rank's (``launch.dryrun.plan`` on ``h100x4``);
47. the ("data", "model") = (2, 2) mesh on four gloo ranks of the card
    (``DATA_MESH``), the batch split over "data": deepseek-v2-lite-16b's
    dense and first MoE layers at full width in float32 under the FSDP
    resolver (8 heads and 32 of 64 experts a "model" rank, each block
    split over "data" too), one ``make_train_step`` of 4 x 256 tokens in
    two microbatches (a row of each a "data" rank) against the
    one-process step, which each rank runs in turn: the loss and norm
    (rtol 1e-5, 1e-4; bitwise equal on the four ranks), every gradient of
    its blocks within 1e-4 of the whole gradient's largest |g|, the
    AdamW update (``check_updates``), every routing of its rows;
48. llama3.2-1b at full width in bfloat16 under FSDP (all 16 layers with
    ``--phase data``, its first 2 in the whole script), 3 steps of 4 x
    2,048 tokens: phase 43's checks and records, the plan on
    ``h100x2x2`` (its peak, its gathers, reduce-scatters and
    all-reduces), the time in gloo by kind;
49. llama3.2-1b whole in bfloat16 under the decode resolver (half the
    weights a rank), batch 4, prompt 256, 16 greedy tokens: tokens
    bitwise equal within each "data" pair, each rank's launches, the
    plan's collectives equal to each rank's; its first 2 layers in
    float32 against one process on each rank's rows; then
    ``flash_attention`` and ``flash_attention_bwd`` at a rank's training
    shape (B=2 S=2,048 16/4 heads of 64) and ``flash_decode`` at its
    serving shape (B=2, 272 positions) against their plain versions,
    timed beside SDPA (``data_shape`` of their records).  One rank set
    runs 42-43, 45-46 and 47-49.

Phases 8a and 18–25 add their launches to the records of
``flash_attention``, ``flash_attention_bwd``, ``flash_decode`` and
``selective_scan_fused`` (``launches_by_path``; the (a, b, C) form's
``selective_scan`` and ``selective_scan_bwd`` run on no model path since
the fused form: their launches are phase 11's op path's); phase 22's
records are
``selective_scan_bwd`` and ``selective_scan_fused_bwd``, whose launches
are phases 23–25's; phase 28's is ``flash_attention_bwd_d192``,
whose launches are phase 29's, which also adds its forward launches to
``flash_attention_d192`` and both to the records of all head dims; phases
31-34 add theirs to ``flash_attention`` and ``flash_decode``, 35-37
theirs to those two and the two scan forwards, 38-41 theirs to
``flash_attention`` and ``flash_attention_bwd``, 42-43 theirs to
the two attention kernels and the four scan kernels, 46 theirs to
``flash_attention`` and ``flash_decode``, and 48-49 theirs to both
attention kernels and ``flash_decode``.  The line
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


START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(what):
    """Log the seconds since the script started, as a phase begins."""
    log(f"[{time.perf_counter() - START:.1f} s] {what}")


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


def timed_call(fn, torch):
    """(``fn()``, its device ms from CUDA events around the one call):
    for a plain version that takes seconds, timed on the call whose
    result is checked."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
# the forward's kept log-sum-exp against attention_lse_ref: that of
# tests/test_torch_cuda.py (float32 sums in another order, ex2.approx)
ATTN_LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# the selective scan: that of tests/test_kernels.py:152
SCAN_TOL = (1e-4, 1e-5)
# the path of the scan's (a, b, C) form since the model runs the fused one
OP_PATH = "ops.selective_scan under autograd"
# falcon-mamba-7b is served on 16 of its 64 layers (a cut of depth that
# keeps the script within its time: 32 before phases 47-49 were added)
# and its card-against-host check runs its first 8
MAMBA_SERVED_LAYERS = 16
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


def traced_window(torch, fn, n: int, tries: int = 3):
    """``torch.profiler``'s device rows (``key_averages``) of ``n`` calls
    of ``fn``: every kernel, copy and memset the calls put on the device.
    A trace that lacks one of the two spin kernels around the window has
    lost events (it may come back empty): it is taken again, up to
    ``tries`` times, and the last one counts."""
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
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(e.count for e in events if "spin_kernel" in e.key)
        if spins == 2:
            break
        log(f"  profiler trace {attempt + 1} of {tries} holds {spins} of "
            f"the 2 spin kernels: it lost events")
    return [e for e in events if "spin_kernel" not in e.key]


def device_ops_per_call(torch, fn, n: int, tries: int = 3):
    """(device operations per call, their names) of ``n`` calls of
    ``fn`` (``traced_window``)."""
    ops = traced_window(torch, fn, n, tries)
    return sum(e.count for e in ops) / n, sorted(e.key for e in ops)


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


class Counter:
    """A wrapper's launch counter that its module keeps under another name
    (``fused_launches``), read and set as ``launches``."""

    def __init__(self, mod, attr):
        self.mod, self.attr = mod, attr

    @property
    def launches(self):
        return getattr(self.mod, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.mod, self.attr, n)


def counted_kernels():
    from repro_torch.kernels.flash_attention import kernel as KA
    from repro_torch.kernels.flash_decode import kernel as KD
    from repro_torch.kernels.mamba_scan import kernel as KS
    return {"flash_attention": KA, "flash_decode": KD, "selective_scan": KS,
            "selective_scan_fused": Counter(KS, "fused_launches")}


def time_steps(torch, prefill, step, prefill_what, step_what, w_bytes,
               who="serve"):
    """Time a prefill and a decode step with CUDA events, beside the least
    time to read the weights once, and profile both (a diagnostic: the run
    goes on without a trace).  Returns the times, the bound, and each
    profile's kernel time and busy share (None without a trace)."""
    prefill_ms = cuda_ms(prefill, torch, 5)
    step_ms = cuda_ms(step, torch, 20)
    least_ms = w_bytes / HBM_BYTES_S * 1e3
    log(f"{who}: prefill ({prefill_what}) {prefill_ms:.3f} ms, decode step "
        f"({step_what}) {step_ms:.3f} ms; reading the weights once takes "
        f"at least {least_ms:.3f} ms")
    out = dict(prefill_ms=prefill_ms, step_ms=step_ms, least_ms=least_ms)
    for label, fn, ms_call in (("prefill", prefill, prefill_ms),
                               ("decode step", step, step_ms)):
        key = label.split()[-1]
        out[f"{key}_kernels_ms"] = out[f"{key}_busy"] = None
        try:
            prof = profile_window(torch, fn, 3)
        except Exception as e:
            prof = None
            log(f"profile {label}: torch.profiler failed ({e!r})")
        if prof is None:
            log(f"profile {label}: no device time in the trace")
            continue
        dev_ms, top = prof
        out[f"{key}_kernels_ms"], out[f"{key}_busy"] = dev_ms, dev_ms / ms_call
        log(f"profile {label}: {dev_ms:.3f} ms of kernels per call "
            f"against {ms_call:.3f} ms between CUDA events (busy "
            f"{dev_ms / ms_call:.1%}); "
            + "; ".join(f"{ms:.3f} ms {k[:60]}" for ms, k in top))
    return out


def serve_model(torch, dev0, cfg, params, launches, per_prefill, per_step):
    """Serve ``SERVE`` through ``CoexecServer`` on two replicas sharing
    ``params``; check that all are served, that every kernel of the path
    launched ``per_prefill[name]`` times a prefill plus ``per_step[name]``
    times a decode step (and the others never), and that the tokens are
    replica-invariant; time a prefill and a decode step and profile
    both.  Records the path's launch counts in ``launches``; returns the
    serving row (served s, tokens/s, peak and weights GB, and
    ``time_steps``'s times and busy shares)."""
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

    row = dict(served=st.served, served_s=st.duration,
               tokens_s=n_req * gen / st.duration, peak_gb=peak_gb,
               weights_gb=w_bytes / 1e9)
    with torch.inference_mode():
        batch = torch.as_tensor(prompts[:lws], device=dev0)
        cache = T.init_cache(cfg, lws, P + gen, dev0)
        row.update(time_steps(
            torch, lambda: T.prefill(cfg, params, batch, cache),
            lambda: T.decode_step(cfg, params, batch[:, :1], cache,
                                  P + gen // 2),
            f"batch {lws} x {P}", f"batch {lws}, pos {P + gen // 2}",
            w_bytes))
    del server, reps, out, cache
    torch.cuda.empty_cache()
    return row


def card_against_host(torch, dev0, cfg32, p32, label, prompt=None,
                      patches=None):
    """Teacher-forced ``PARITY`` in float32 (TF32 off) with ``p32`` on
    the card (kernels) and then on the host (plain versions); the logits
    must agree within 1e-3 of the largest.  ``prompt`` replaces PARITY's
    prompt length; ``patches`` (numpy, (batch, n, d)) go to the prefill
    (the ``vit_stub`` frontend); an ``encodec_stub`` model takes tokens
    of all its codebooks.  Moves ``p32`` to the host."""
    B2, P2, n_steps = (PARITY[k] for k in ("batch", "prompt", "steps"))
    P2 = prompt or P2
    cb = ((cfg32.n_codebooks,) if cfg32.frontend == "encodec_stub"
          else ())
    ptoks = np.random.default_rng(1).integers(
        0, cfg32.vocab_size, (B2, P2 + n_steps) + cb).astype(np.int32)

    t0 = time.perf_counter()
    card = teacher_forced(torch, cfg32, p32, ptoks, P2, dev0, patches=patches)
    t_card = time.perf_counter() - t0
    p32.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = teacher_forced(torch, cfg32, p32, ptoks, P2, torch.device("cpu"),
                          patches=patches)
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


def sdpa_backends(torch, fn):
    """The device kernels that one call of ``fn`` (an SDPA call) runs, by
    name (``traced_window``): which of PyTorch's backends took it."""
    return sorted({e.key.split("(")[0].split("<")[0][:48]
                   for e in traced_window(torch, fn, 1)})


def attn_check(torch, randn, B, S, h, kh, d, dtype, timed=False, dv=None):
    """Hold ``flash_attention`` against ``attention_ref`` on (B, S, h, d)
    queries, (B, S, kh, d) keys and (B, S, kh, dv) values (``dv``: d
    unless given) from ``randn`` at ``ATTN_TOL``; at dv < d also the kept
    log-sum-exp against ``attention_lse_ref`` at ``ATTN_LSE_TOL`` and the
    output with it bitwise equal to the one without.  With ``timed``, time
    kernel, plain version and SDPA and return the measurements for a
    kernel record; at dv < d SDPA runs twice, on v zero-padded to d (what
    one equal-width call computes) and on v at dv, each with the backend
    it took, and the faster is the record's yardstick."""
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    F = torch.nn.functional
    dv = d if dv is None else dv
    q, k, v = (randn(s, dtype) for s in ((B, S, h, d), (B, S, kh, d),
                                         (B, S, kh, dv)))
    got = KA.flash_attention(q, k, v)
    want = RA.attention_ref(q, k, v)
    rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    err = float((got.float() - want.float()).abs().max())
    shape = (f"B={B} S={S} H={h} KH={kh} D={d}"
             + (f" Dv={dv}" if dv != d else "") + f" {dtype}")
    log(f"  flash_attention {shape}: max abs err {err:.3g}")
    if dv != d:
        out, lse = KA.flash_attention_fwd(q, k, v, keep_lse=True)
        check(torch.equal(out, got), f"flash_attention {shape}: the output "
                                     f"differs when it keeps the lse")
        lse_want = RA.attention_lse_ref(q, k, v)
        torch.testing.assert_close(lse, lse_want, **ATTN_LSE_TOL)
        log(f"  flash_attention {shape}: kept log-sum-exp max abs err "
            f"{float((lse - lse_want).abs().max()):.3g}")
        del out, lse, lse_want
    if not timed:
        return None
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    vpt = F.pad(vt, (0, d - dv)) if dv != d else vt

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vpt, is_causal=True,
                                              enable_gqa=True)

    lib = sdpa()[..., :dv]
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
        library_ms=cuda_ms(sdpa, torch),
        nbytes=elt * B * S * (h + kh) * (d + dv),
        ops=2.0 * B * h * (d + dv) * S * (S + 1) / 2,
        ops_per_s=BF16_OPS_S if dtype == torch.bfloat16 else FP32_OPS_S)
    if dv != d:
        # SDPA on v at its own width, where this PyTorch takes it
        def sdpa_dv():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=h != kh)

        res["library_pad_ms"] = res["library_ms"]
        res["library_pad_backend"] = sdpa_backends(torch, sdpa)
        try:
            lib_dv = sdpa_dv()
        except RuntimeError as e:
            log(f"  sdpa on v at {dv} columns refused: {e}")
            res["library_dv_ms"] = res["library_dv_backend"] = None
        else:
            diff = (lib_dv.transpose(1, 2).float() - got.float()).abs()
            log(f"  sdpa (v at {dv}) vs kernel max abs diff "
                f"{float(diff.max()):.3g}")
            res["library_dv_ms"] = cuda_ms(sdpa_dv, torch)
            res["library_dv_backend"] = sdpa_backends(torch, sdpa_dv)
            res["library_ms"] = min(res["library_ms"], res["library_dv_ms"])
            del lib_dv
        log(f"  sdpa on v padded to {d}: {res['library_pad_ms']:.4f} ms "
            f"({res['library_pad_backend']}); on v at {dv}: "
            f"{res['library_dv_ms']} ms ({res['library_dv_backend']})")
    log(f"  timed {shape}: kernel {res['ms']:.4f} ms (keeping the "
        f"log-sum-exp {res['keep_lse_ms']:.4f} ms), SDPA "
        f"{res['library_ms']:.4f} ms, kernel/SDPA "
        f"{res['ms'] / res['library_ms']:.3f}")
    del q, k, v, qt, kt, vt, vpt, got, want, lib
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


def scan_kernel_check(torch, dev0, gen_t, B, S, d, s, with_h0=False,
                      timed=False):
    """Hold ``selective_scan`` against its plain version on (B, S, d, s)
    inputs drawn from ``gen_t`` at ``SCAN_TOL``; with ``timed``, time both
    and return the measurements for a kernel record."""
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS

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


def fused_inputs(torch, dev0, gen_t, B, S, d, s, dtype, with_h0):
    """The fused scan's inputs on the card: dt in [0.01, 0.5) and x
    standard normal in ``dtype``, A = -(1 .. s) in every channel (the
    model's initial A), B, C and h0 standard normal in float32."""
    dt = (0.01 + 0.49 * torch.rand((B, S, d), generator=gen_t,
                                   device=dev0)).to(dtype)
    x = torch.randn((B, S, d), generator=gen_t, device=dev0).to(dtype)
    A = -torch.arange(1, s + 1, dtype=torch.float32,
                      device=dev0).repeat(d, 1)
    Bm = torch.randn((B, S, s), generator=gen_t, device=dev0)
    C = torch.randn((B, S, s), generator=gen_t, device=dev0)
    h0 = (torch.randn((B, d, s), generator=gen_t, device=dev0)
          if with_h0 else None)
    return dt, x, A, Bm, C, h0


def fused_scan_check(torch, dev0, gen_t, B, S, d, s, dtype, with_h0=False,
                     timed=False):
    """Hold ``selective_scan_fused`` against its plain version (the
    eager discretisation, then the plain scan) on (B, S, d, s) inputs at
    ``SCAN_TOL``; with ``timed``, time both and return the measurements
    for a kernel record."""
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS

    args = fused_inputs(torch, dev0, gen_t, B, S, d, s, dtype, with_h0)
    y, h = KS.selective_scan_fused(*args)
    yr, hr = RS.selective_scan_fused(*args)
    rtol, atol = SCAN_TOL
    torch.testing.assert_close(y, yr, rtol=rtol, atol=atol)
    torch.testing.assert_close(h, hr, rtol=rtol, atol=atol)
    check(bool(torch.isfinite(y).all()), "selective_scan_fused: y not "
                                         "finite")
    err = max(float((y - yr).abs().max()) if y.numel() else 0.0,
              float((h - hr).abs().max()))
    shape = (f"B={B} S={S} di={d} ds={s} {str(dtype)[6:]} dt, x"
             + (" h0" if with_h0 else ""))
    log(f"  selective_scan_fused {shape}: max abs err {err:.3g}")
    res = None
    if timed:
        # dt and x read in their type, A, B, C (and h0) in float32, y and
        # h_T written once; per (t, d, s) the kernel's least float
        # operations (KS.FUSED_FLOPS) and its exp, counted as one
        esize = args[0].element_size()
        res = dict(
            err=err, shape=shape,
            ms=cuda_ms(lambda: KS.selective_scan_fused(*args), torch),
            plain_ms=cuda_ms(lambda: RS.selective_scan_fused(*args),
                             torch, 1),
            library_ms=None,
            nbytes=2.0 * esize * B * S * d + 4.0 * (
                d * s + 2 * B * S * s + B * S * d
                + B * d * s * (2 if with_h0 else 1)),
            ops=(KS.FUSED_FLOPS + 1) * B * S * d * s, ops_per_s=FP32_OPS_S)
        log(f"  timed {shape}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.3f} ms")
    del args, y, h, yr, hr
    torch.cuda.empty_cache()
    return res


def plane_ops(torch, fn, shape):
    """The ops of one call of ``fn`` (under ``torch.profiler``, their
    input shapes recorded) that read a tensor of ``shape``: a Mamba
    layer's (B, S, di, ds) plane."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    want = list(shape)
    return sorted({e.name for e in prof.events()
                   if any(list(sh) == want for sh in (e.input_shapes or ())
                          if isinstance(sh, (list, tuple)))})


def scan_op_path(torch, dev0, gen_t, B, S, d, s):
    """The path of the (a, b, C) form, whose model paths run the fused
    form: the port's scan op (``kernels/mamba_scan/ops.py``
    ``selective_scan``, the JAX package's op of the same name) on (B, S,
    d, s) planes that require grad, and its gradient.  The counters are
    set to 0 just before and read just after: one forward (keeping its
    states) and one backward launch.  Returns the two counts."""
    from repro_torch.kernels.mamba_scan import kernel as KS, ops as OS

    a = (0.5 + 0.49 * torch.rand((B, S, d, s), generator=gen_t,
                                 device=dev0)).requires_grad_()
    b = (0.1 * torch.randn((B, S, d, s), generator=gen_t,
                           device=dev0)).requires_grad_()
    C = torch.randn((B, S, s), generator=gen_t, device=dev0).requires_grad_()
    KS.launches = KS.bwd_launches = 0
    y, h = OS.selective_scan(a, b, C)
    grads = torch.autograd.grad(y.sum() + h.sum(), (a, b, C))
    torch.cuda.synchronize()
    got = {"selective_scan": KS.launches,
           "selective_scan_bwd": KS.bwd_launches}
    check(got == {"selective_scan": 1, "selective_scan_bwd": 1},
          f"{OP_PATH}: launches {got}, expected one forward and one backward")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{OP_PATH}: gradients not finite")
    log(f"{OP_PATH} at B={B} S={S} di={d} ds={s} float32: y {tuple(y.shape)}, "
        f"finite gradients of a, b and C; launches {got}")
    del a, b, C, y, h, grads
    torch.cuda.empty_cache()
    return got


def mamba_phases(args, torch, dev0, launches, record):
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = replace(get_config("falcon-mamba-7b"),
                  n_layers=2 if args.small else MAMBA_SERVED_LAYERS)
    P, lws = SERVE["prompt"], SERVE["lws"]
    di, ds = cfg.d_inner, cfg.ssm.d_state

    # -------------------------------------------------- serve, full width
    params = make_params(torch, dev0, cfg)
    serve_model(torch, dev0, cfg, params, launches,
                per_prefill={"selective_scan_fused": cfg.n_layers,
                             "selective_scan": 0}, per_step={})
    # no op of a prefill reads a (B, S, di, ds) plane: the discretisation
    # runs inside the fused kernel
    with torch.inference_mode():
        batch = torch.as_tensor(np.zeros((lws, P), np.int32), device=dev0)
        cache = T.init_cache(cfg, lws, P + 1, dev0)
        planes = plane_ops(torch, lambda: T.prefill(cfg, params, batch,
                                                    cache),
                           (lws, P, di, ds))
    check(not planes, f"serve: a prefill's ops {planes} read a "
                      f"{(lws, P, di, ds)} plane")
    log(f"serve: no op of a traced prefill reads a {(lws, P, di, ds)} "
        f"plane (torch.profiler, input shapes)")
    del batch, cache

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

    def scan_check(*shape, **kw):
        return scan_kernel_check(torch, dev0, gen_t, *shape, **kw)

    log("selective_scan against its plain version:")
    serve_s = scan_check(lws, P, di, ds, timed=True)
    long_s = scan_check(2, 1024 if args.small else 4096, di, ds, timed=True)
    scan_check(1, 1000, 1000, 8, with_h0=True)        # ragged, a state
    op_path = scan_op_path(torch, dev0, gen_t, lws, P, di, ds)
    record("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
           "src/repro/kernels/mamba_scan/kernel.py:55", serve_s["err"],
           serve_s["ms"], serve_s["plain_ms"], serve_s["nbytes"],
           serve_s["ops"], None, serve_s["shape"] + " (serving prefill)",
           n_launches=op_path["selective_scan"],
           launches_by_path={
               "falcon-mamba-7b": launches["selective_scan"],
               OP_PATH: op_path["selective_scan"]},
           long_shape=long_entry(long_s),
           library_note="no single PyTorch call computes this recurrence")
    bf16 = torch.bfloat16
    log("selective_scan_fused against its plain version:")
    fused_s = fused_scan_check(torch, dev0, gen_t, lws, P, di, ds, bf16,
                               timed=True)
    fused_l = fused_scan_check(torch, dev0, gen_t, 2,
                               1024 if args.small else 4096, di, ds, bf16,
                               timed=True)
    # a rank's share of jamba's d_inner (timed in phase 37), ragged S and
    # an odd di (bfloat16 rows staged by loads, not cp.async) with a state
    fused_scan_check(torch, dev0, gen_t, lws, P, di // 4, ds, bf16)
    fused_scan_check(torch, dev0, gen_t, 1, 1000, 1001, 8, bf16,
                     with_h0=True)
    fused_scan_check(torch, dev0, gen_t, 2, 333, 520, ds, torch.float32,
                     with_h0=True)
    record("selective_scan_fused", "src/repro_torch/csrc/selective_scan.cu",
           "src/repro/kernels/mamba_scan/kernel.py:55", fused_s["err"],
           fused_s["ms"], fused_s["plain_ms"], fused_s["nbytes"],
           fused_s["ops"], None, fused_s["shape"] + " (serving prefill)",
           long_shape=long_entry(fused_l),
           replaces_note="that kernel's function with Mamba's "
                         "discretisation (src/repro/models/layers.py:"
                         "608-611) taken in",
           library_note="no single PyTorch call computes this recurrence")
    return op_path


# ------------------------------------------------ MLA and MoE (deepseek)
# deepseek-v2-lite-16b is served on 7 of its 27 layers (the dense first
# and 6 MoE: a cut of depth that keeps the script within its time, 14
# before phases 47-49 were added); the card-against-host check runs the
# dense first layer and two MoE layers
MLA_SERVED_LAYERS = 7
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
    # --small: the dense layer and one MoE
    cfg = replace(get_config("deepseek-v2-lite-16b"),
                  n_layers=2 if args.small else MLA_SERVED_LAYERS)
    m = cfg.mla
    H, D, DV = cfg.n_heads, m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    P, lws = SERVE["prompt"], SERVE["lws"]
    bf16, f32 = torch.bfloat16, torch.float32

    # ------------------------------- phase 15: the kernel at D = 192
    gen_t = torch.Generator(dev0).manual_seed(4)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"flash_attention at MLA's head dims (q, k {D}; v {DV}) against "
        f"its plain version:")
    mla_a = attn_check(torch, randn, lws, P, H, H, D, bf16, timed=True,
                       dv=DV)
    long_S = 1024 if args.small else 4096
    long_a = attn_check(torch, randn, 1, long_S, H, H, D, bf16, timed=True,
                        dv=DV)
    for S_, h_, kh_ in ((1000, H, H), (127, H, H), (129, H, H),   # ragged
                        (77, 4, 2), (300, 8, 4),                 # G = 2
                        (129, 6, 2)):                            # G = 3
        attn_check(torch, randn, 2, S_, h_, kh_, D, bf16, dv=DV)
    for S_, h_, kh_ in ((P, H, H), (1000, H, H), (77, 4, 2)):
        attn_check(torch, randn, lws if S_ == P else 2, S_, h_, kh_, D, f32,
                   dv=DV)
    # the equal-width instance (v of 192 columns), which MLA's model no
    # longer calls: held and timed at the prefill shape
    log("flash_attention at D = Dv = 192 (v zero-padded, the earlier "
        "model's call):")
    eq_a = attn_check(torch, randn, lws, P, H, H, D, bf16, timed=True)
    attn_check(torch, randn, 2, 77, 4, 2, D, bf16)        # G = 2, ragged
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
           long_shape=long_entry(long_a),
           library_note="the faster of two F.scaled_dot_product_attention"
                        "(is_causal=True) calls: v zero-padded to D "
                        "(library_pad_ms) and v at Dv (library_dv_ms)",
           **{f"{key}_{sh}": r[key] for sh, r in (("prefill", mla_a),
                                                  ("long", long_a))
              for key in ("library_pad_ms", "library_dv_ms",
                          "library_pad_backend", "library_dv_backend")},
           equal_width_shape=long_entry(eq_a, "D = Dv = 192"))

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
# serves one of its four periods of 8 (8 layers, 26.6 GB: a cut of depth
# that keeps the script within its time), in phase 18 and on four ranks
# in phase 36
JAMBA_SERVED_LAYERS = 8
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
                  "selective_scan": "falcon-mamba-7b",
                  "selective_scan_fused": "falcon-mamba-7b"}


def jamba_phases(args, torch, dev0):
    """Hold the attention kernels at jamba's heads (D = 128, H = 32, KH =
    8) and serve jamba-v0.1-52b at full width on 8 of its 32 layers
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

    # ------------------ phase 18: serve at full width, 8 layers, bf16
    params = make_params(torch, dev0, cfg)
    served = {}
    serve_model(torch, dev0, cfg, params, served,
                per_prefill={"flash_attention": n_attn,
                             "selective_scan_fused": cfg.n_layers - n_attn,
                             "selective_scan": 0},
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
            "selective_scan": 0, "selective_scan_fused": 0}
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
            "selective_scan": 0, "selective_scan_fused": 0}
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
# TRAIN_4K's global batch of 256 cut to 4, 4 steps, at its 4,096 tokens
# where the plan of a one-row packet, times ``plan_margin``, says two
# groups fit under PLAN_FILL of the card (the state, the bfloat16 sums of
# the gradients and a packet in flight a group, as dense_train_plan
# reckons them), else at 2,048.  Before the fused scan the two groups'
# first step at 4,096 ran out of the card's memory (67.60 GiB allocated
# and 8.80 GiB reserved unallocated when a 2 GiB block was asked for).
# With it the plan at 4,096 is 63.70 GB and two groups' steps there peak
# at 66.91 GB allocated, but the caching allocator reserves 83.33 GB of
# the card's 85.0 with a retry (PERF.md, run SF7), and a second training
# in the same process ran out of memory: the margin is reserved over
# planned, 1.308, rounded up, so the phase trains at 2,048 until a
# packet's peak comes down
JAMBA_TRAIN_RUN = dict(batch=4, steps=4, seq=4096, fallback_seq=2048,
                       plan_margin=1.31)
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
    """The kernel counters of a training packet: the four it runs and
    the scan's (a, b, C) form, which it must not run."""
    from repro_torch.kernels.flash_attention import kernel as KA
    from repro_torch.kernels.mamba_scan import kernel as KS
    return {"flash_attention": (KA, "launches"),
            "flash_attention_bwd": (KA, "bwd_launches"),
            "selective_scan_fused": (KS, "fused_launches"),
            "selective_scan_fused_bwd": (KS, "fused_bwd_launches"),
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
    forward kernel as often as the step runs the layer's forward (the
    forward and its rematerialised recomputes, ``T.forward_runs``: twice
    under a flat remat, three times inside a remat group but for the
    group's last layer) and its backward once; a Mamba layer runs the
    fused scan, never the (a, b, C) form."""
    from repro_torch.models import transformer as T
    runs = T.forward_runs(cfg)
    attn = [cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers)]
    return {"flash_attention": sum(r for r, a in zip(runs, attn) if a),
            "flash_attention_bwd": sum(attn),
            "selective_scan_fused": sum(r for r, a in zip(runs, attn)
                                        if not a),
            "selective_scan_fused_bwd": len(attn) - sum(attn),
            "selective_scan": 0, "selective_scan_bwd": 0}


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
              ("scan forward", ("scan_fwd_kernel",)),
              ("scan backward", ("scan_bwd_kernel",)),
              ("dB and dC sums", ("scan_partial_sum",)),
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
                 must_learn=False, held_out=False, groups=2, opt=None):
    """Train ``cfg`` (random weights from seed 0) through
    ``HeteroDPTrainer``: ``groups`` groups on ``dev0`` (two: throttles 1
    and 2; one: throttle 1), ``SyntheticPipeline`` (seed 1234), lws 1,
    AdamW (``opt``, by default ``TRAIN_OPT``).
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
    opt = OptConfig(**(opt or TRAIN_OPT))
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
              DeviceGroup("g1", device=dev0, throttle=2.0)][:groups]
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
                   peak_gb=peak / 1e9, launches=run, losses=losses,
                   step_times=[r.step_time_s for r in reports])
    log(f"train {label}: losses {[round(x, 4) for x in losses]}; steps "
        f"2-{len(reports)} {step_s:.3f} s a step, "
        f"{batch * seq / step_s:.0f} tokens/s; rows {rows}; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated; reserved "
        f"{reserved / 1e9:.2f} GB, {retries} allocator retries in the "
        f"{len(reports)} steps); launches in the run {run}")
    del trainer, state
    return params, summary


def train_card_against_host(torch, dev0, cfg32, p32, batch, label,
                            opt=None):
    """One loss and gradient in float32 (TF32 off), ``p32`` on the card
    (kernels) and a copy on the host (plain versions), on the numpy
    ``batch``: the loss within 1e-4 relative and every gradient within
    1e-3 of its parameter's largest |g|.  With MoE layers, every token
    routed to the same experts on both sides and in the rematerialised
    recompute as in the forward; the smallest top-k margin is logged.
    With ``opt``, one AdamW step from fresh moments on each side, the
    updated parameters held by ``check_updates`` (``p32`` is updated)."""
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
    if opt is not None:
        from repro_torch.optim import adamw
        sc = adamw.apply_updates(adamw.init_state(p32, opt), gc, opt)[0]
        sh = adamw.apply_updates(adamw.init_state(host32, opt), gh, opt)[0]
        worst_p, outside, n_el = check_updates(
            torch, sc.params, sh.params, opt.lr, f"train parity {label}")
        route_note += (f"; after one AdamW step the parameters within "
                       f"{worst_p:.3g} of 1e-3 of their largest |value|, "
                       f"{outside} of {n_el} elements outside (at most "
                       f"{TRAIN_FLIPS:g} of them)")
        del sc, sh
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


def fused_scan_bwd_check(torch, dev0, gen_t, B, S, d, s, dtype,
                         nonzero=False, timed=False):
    """Hold ``selective_scan_fused_bwd``, fed the states the fused
    forward keeps, against ``selective_scan_fused_bwd_ref``: every output
    within ``SCAN_BWD_TOL`` of its largest |value| (d_dt and d_x in
    bfloat16 also within one bfloat16 step, at most 2^-7 of each value:
    both sides round their float32 sums at the end), two calls bitwise
    equal; with
    ``timed``, time kernel and plain version and return the measurements
    for a kernel record."""
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS

    args = fused_inputs(torch, dev0, gen_t, B, S, d, s, dtype, nonzero)
    dy = torch.randn((B, S, d), generator=gen_t, device=dev0)
    dhT = (torch.randn((B, d, s), generator=gen_t, device=dev0) if nonzero
           else None)
    _, _, states = KS.selective_scan_fused_fwd(*args, keep_states=True)
    got = KS.selective_scan_fused_bwd(*args, dy, dhT, states)
    again = KS.selective_scan_fused_bwd(*args, dy, dhT, states)
    want, plain_ms = timed_call(
        lambda: RS.selective_scan_fused_bwd_ref(*args, dy, dhT), torch)
    shape = (f"B={B} S={S} di={d} ds={s} {str(dtype)[6:]} dt, x"
             + (" h0 dhT" if nonzero else ""))
    rtol, atol = SCAN_BWD_TOL
    err = 0.0
    names = ("d_dt", "d_x", "dA", "dB", "dC", "dh0")
    for name, g, r, w in zip(names, got, again, want):
        check(torch.equal(g, r), f"selective_scan_fused_bwd {shape}: "
                                 f"{name} differs between two calls")
        half = g.element_size() == 2
        g, w = g.float(), w.float()
        if not w.numel():
            continue
        e, top = (g - w).abs(), float(w.abs().max())
        step = 2 ** -7 * w.abs() if half else 0.0
        worst = float((e - step).max())
        check(worst <= rtol * top + atol,
              f"selective_scan_fused_bwd {shape}: {name} max |err| "
              f"{float(e.max()):.3g} above {rtol} x {top:.3g} + {atol}")
        err = max(err, float(e.max()))
    log(f"  selective_scan_fused_bwd {shape}: max abs err {err:.3g}, two "
        f"calls bitwise equal")
    res = None
    if timed:
        # dt, x, dy, B, C, A, the kept states (and dhT) read once; d_dt,
        # d_x, dA, dB, dC and dh0 written once; per (t, d, s) the
        # kernel's least float operations (KS.FUSED_BWD_FLOPS: 19) and
        # its exp, counted as one
        esize = args[0].element_size()
        res = dict(
            err=err, shape=shape,
            ms=cuda_ms(lambda: KS.selective_scan_fused_bwd(
                *args, dy, dhT, states), torch),
            plain_ms=plain_ms, library_ms=None,
            nbytes=4.0 * esize * B * S * d + 4.0 * (
                B * S * d + 4 * B * S * s + states.numel() + 2 * d * s
                + B * d * s * (2 if nonzero else 1)),
            ops=(KS.FUSED_BWD_FLOPS + 1) * B * S * d * s,
            ops_per_s=FP32_OPS_S)
        log(f"  timed {shape}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.3f} ms")
    del args, dy, dhT, states, got, again, want
    torch.cuda.empty_cache()
    return res


def scan_bwd_phase(args, torch, dev0):
    """Phase 22: the scan's backward kernels, the (a, b, C) form's and
    the fused form's, against their plain versions at the training packet
    (timed) and at their edges.  Returns the training packet's
    measurements of both."""
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
    edges = ((2, 1000, 1000, 16), (1, 1, 8192, 16), (2, 333, 520, 8),
             (1, 77, 300, 32), (3, 16, 33, 5))
    for B, S_, d, s in edges:
        scan_bwd_check(torch, dev0, gen_t, B, S_, d, s, nonzero=True)
    scan_bwd_check(torch, dev0, gen_t, 1, 100, 4100, 16)
    log("selective_scan_fused_bwd against its plain version:")
    bf16 = torch.bfloat16
    fused = fused_scan_bwd_check(torch, dev0, gen_t, 1, S, di, ds, bf16,
                                 timed=True)
    # a rank's training share of jamba's d_inner (timed in phase 43)
    fused_scan_bwd_check(torch, dev0, gen_t, 1, S // 2, di // 4, ds, bf16)
    for B, S_, d, s in edges:
        fused_scan_bwd_check(torch, dev0, gen_t, B, S_, d, s,
                             torch.float32, nonzero=True)
    fused_scan_bwd_check(torch, dev0, gen_t, 2, 100, 1001, 16, bf16,
                         nonzero=True)                # odd di in bfloat16
    return packet, fused


def jamba_train_seq(torch, dev0, cfg, S):
    """``S`` if the plan of one row of ``S`` tokens (``launch.dryrun`` on
    one card), times ``JAMBA_TRAIN_RUN["plan_margin"]``, lets two groups
    train ``cfg`` under ``PLAN_FILL`` of the card less what it holds: the
    state, the bfloat16 sums of the gradients and one packet in flight a
    group; else ``JAMBA_TRAIN_RUN["fallback_seq"]``."""
    from dataclasses import replace

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T

    total = torch.cuda.get_device_properties(dev0).total_memory
    held = torch.cuda.memory_allocated(dev0)
    # a packet is one row in one microbatch (the config's accum_override
    # splits a training batch, not a packet)
    rec = D.plan(replace(cfg, accum_override=0),
                 ShapeConfig(f"train_{S}_packet", S, 1, "train"),
                 make_test_mesh(1))
    sums = T.param_bytes(T.init_abstract(cfg))
    need = rec["argument_bytes_allocated"] + sums + 2 * rec["step_peak_bytes"]
    margin = JAMBA_TRAIN_RUN["plan_margin"]
    fits = margin * need <= PLAN_FILL * total - held
    log(f"plan {cfg.name} ({cfg.n_layers} layers) x one row of {S}: "
        f"arguments {rec['argument_bytes_allocated'] / 1e9:.3f} GB, a "
        f"packet {rec['step_peak_bytes'] / 1e9:.3f} GB, the gradients' sums "
        f"{sums / 1e9:.3f} GB: two groups {need / 1e9:.3f} GB, x {margin} "
        f"(the allocator's reserve over the plan at 4,096) against "
        f"{(PLAN_FILL * total - held) / 1e9:.3f} GB ({PLAN_FILL} of the "
        f"card's {total / 1e9:.1f} GB less {held / 1e9:.2f} GB held): "
        + (f"trained at {S} tokens" if fits else
           f"trained at {JAMBA_TRAIN_RUN['fallback_seq']} tokens"))
    return S if fits else JAMBA_TRAIN_RUN["fallback_seq"]


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
    if not args.small:
        S = jamba_train_seq(torch, dev0, cfg, S)
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
    # one more step traced: no op of it may read a (B, S, di, ds) plane
    plane = (B, S, cfg.d_inner, cfg.ssm.d_state)
    out = []
    planes = plane_ops(torch, lambda: out.append(step_fn(state, batch)),
                       plane)
    check(not planes, f"train {cfg.name}: a step's ops {planes} read a "
                      f"{plane} plane")
    log(f"train {cfg.name}: no op of a traced step reads a {plane} plane "
        f"(torch.profiler, input shapes)")
    state = out[0][0]
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


# ------------------------------- the planner and MLA training (26-30)
# the caching allocator's largest unsplit remainder of a block (bytes)
ALLOC_UNSPLIT = 1 << 20
# the planner's meshes: one card, and four cards of one host
PLAN_MESHES = ("h100", "h100x4")
# processes that plan the cells on the host: the machine's 8 cores when
# phase 26 runs alone (--phase plan), 3 beside the card phases (with 8 in
# the background from phase 3 on, phases 3-25 took 123 s longer than in
# the foreground run before: the cores are shared; PERF.md, run S5)
PLAN_WORKERS = 8
PLAN_BACKGROUND_WORKERS = 3
# the planned peak of a training step against the card's
# max_memory_allocated: |measured / planned - 1| at most this (found on
# the card: llama3.2-1b's cell 1.0025, deepseek's 1.0002; PERF.md)
PLAN_PEAK_TOL = 0.02
# deepseek-v2-lite-16b trained at full width on its first 3 layers (the
# dense one, two MoE), TRAIN_4K's 256 rows cut to 4 as llama's are to 8,
# fewer if the plan says two groups' packets do not fit the card
DEEPSEEK_TRAIN = dict(layers=3, batch=4, seq=4096, steps=4)
# the share of the card's memory the state and two packets may fill
PLAN_FILL = 0.85
# card against host in float32 on the first 2 layers, 1 x 256 tokens
DEEPSEEK_PARITY_LAYERS = 2


def _plan_cell(cell):
    """One cell's records on ``PLAN_MESHES`` (a worker of phase 26)."""
    from repro_torch.launch import dryrun as D
    return D.plan_meshes(*cell, mesh_names=PLAN_MESHES)


def sharded_note(rec) -> str:
    """A four-card serve record's rank 0 step: its collectives, or why
    the config is refused."""
    step = rec.get("sharded_step")
    if step is None:
        return ""
    return f"; rank 0's step: {step.get('refused') or rec['collectives']}"


def start_plan(workers=PLAN_WORKERS):
    """Start phase 26's planning of every cell on one card and four in a
    thread of its own, which runs the cells in ``workers`` spawned
    processes at the lowest priority (``os.nice(19)``: they take the
    cores the card phases leave idle) and stops them when the last cell
    is planned.  Returns (the thread, the dict it fills: "recs", "wall",
    "cells" and "workers", or "error")."""
    import multiprocessing as mp
    import os
    import threading
    import traceback

    from repro_torch.launch import dryrun as D

    # the training cells (the longest steps on meta) first
    cells = sorted(D.cell_list(), key=lambda c: not c[1].startswith("train"))
    out = {"cells": len(cells), "workers": workers}

    def run():
        t0 = time.perf_counter()
        try:
            with mp.get_context("spawn").Pool(
                    workers, initializer=os.nice,
                    initargs=(19,)) as pool:
                out["recs"] = [r for pair in pool.map(_plan_cell, cells,
                                                      chunksize=1)
                               for r in pair]
        except BaseException:
            out["error"] = traceback.format_exc()
        out["wall"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, out


def plan_phase(args, started=None):
    """26. Plan every cell on one card and four (``started``: a
    ``start_plan`` already running); returns the records."""
    thread, out = started or start_plan()
    t0 = time.perf_counter()
    thread.join()
    check("error" not in out, f"plan: {out.get('error')}")
    recs, wall = out["recs"], out["wall"]
    log(f"plan: waited {time.perf_counter() - t0:.1f} s for it")
    for r in recs:
        check(r["flops"] > 0 and r["argument_bytes_per_device"] > 0,
              f"plan {r['arch']} x {r['shape']} x {r['mesh']}: empty")
        calls = {k: int(v["calls"]) for k, v in r["kernels"].items()}
        log(f"plan {r['arch']} x {r['shape']} x {r['mesh']}: arguments "
            f"{r['argument_bytes_per_device'] / 1e9:.3f} GB a device "
            f"({', '.join(f'{k} {v / 1e9:.3f}' for k, v in r['per_device_bytes'].items())}), "
            f"predicted peak {r['predicted_peak_bytes_per_device'] / 1e9:.3f}"
            f" GB a device, flops {r['flops']:.4e} ({r['flops_per_device']:.4e}"
            f" a device, dots {r['dot_flops']:.4e}), traffic "
            f"{r['traffic_bytes']:.4e} B, kernels {calls}; the step on meta "
            f"in {r['meta_run_s']:.1f} s" + sharded_note(r))
    log(f"plan: {out['cells']} cells x {len(PLAN_MESHES)} meshes in "
        f"{wall:.1f} s wall ({out['workers']} processes at nice 19, meta "
        f"device)")
    return recs


def plan_against_card(torch, dev0, cfg, shape, rec, label, steps=2):
    """Build the training cell's state and tokens on the card and hold
    them against the plan ``rec`` (one card): the bytes asked of the
    caching allocator equal the planned argument bytes, and
    ``memory_allocated`` their 512-byte rounding plus at most the
    allocator's unsplit remainder (``ALLOC_UNSPLIT``) a tensor; then
    ``steps`` of
    ``make_train_step`` with the plan's microbatches, the first's peak
    (``max_memory_allocated``) within ``PLAN_PEAK_TOL`` of the planned
    peak; each step's model-FLOP share (the plan's flops over the step's
    time over the card's bfloat16 peak).  Returns a summary."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.step import make_train_step

    free_card(torch, dev0, f"plan against the card, {label}")
    torch.cuda.synchronize(dev0)

    def stats():
        st = torch.cuda.memory_stats(dev0)
        return st["allocated_bytes.all.current"], st.get(
            "requested_bytes.all.current")

    alloc0, req0 = stats()
    opt = OptConfig(**TRAIN_OPT)
    state = adamw.init_state(
        T.init_params(cfg, torch.Generator(dev0).manual_seed(0)), opt)
    gen = torch.Generator(dev0).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           generator=gen, device=dev0, dtype=torch.int32)
    torch.cuda.synchronize(dev0)
    alloc1, req1 = stats()
    args_alloc = alloc1 - alloc0
    want, want_alloc = (rec["argument_bytes_per_device"],
                        rec["argument_bytes_allocated"])
    if req0 is not None:
        check(req1 - req0 == want,
              f"plan {label}: the state and tokens asked for "
              f"{req1 - req0} bytes, planned {want}")
    # the allocator hands a request of more than 1 MiB a whole block when
    # what would be left of it is 1 MiB or less: up to 1 MiB a tensor
    n_large = sum(t.numel() * t.element_size() > ALLOC_UNSPLIT
                  for part in (list(state.params.parameters()),
                               list(state.mu.values()),
                               list(state.nu.values()), [tokens])
                  for t in part)
    log(f"plan {label}: arguments {want} bytes planned, {want_alloc} "
        f"rounded to 512; on the card {None if req0 is None else req1 - req0}"
        f" requested, {args_alloc} allocated (allocated - rounded "
        f"{args_alloc - want_alloc} bytes, {n_large} tensors above 1 MiB)")
    check(0 <= args_alloc - want_alloc <= n_large * ALLOC_UNSPLIT,
          f"plan {label}: {args_alloc} bytes allocated, planned "
          f"{want_alloc} rounded")
    step = make_train_step(cfg, opt, accum_steps=rec["accum_steps"])
    torch.cuda.reset_peak_memory_stats(dev0)
    times, shares = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        torch.cuda.synchronize(dev0)
        times.append(time.perf_counter() - t0)
        shares.append(rec["flops"] / times[-1] / BF16_OPS_S)
        if i == 0:
            peak = torch.cuda.max_memory_allocated(dev0) - alloc0
        check(math.isfinite(float(m["loss"])),
              f"plan {label}: loss {float(m['loss'])}")
        log(f"plan {label} step {i}: loss {float(m['loss']):.4f}, "
            f"{times[-1]:.3f} s, model-FLOP share {shares[-1]:.4f} "
            f"({rec['flops']:.4e} planned flops / step time / 989e12)")
    want_peak = rec["predicted_peak_bytes_per_device"]
    ratio = peak / want_peak
    log(f"plan {label}: peak of one step {peak / 1e9:.3f} GB "
        f"(max_memory_allocated over the state's start), planned "
        f"{want_peak / 1e9:.3f} GB (arguments {want_alloc / 1e9:.3f} + "
        f"step {rec['step_peak_bytes'] / 1e9:.3f}), measured/planned "
        f"{ratio:.4f} (limit 1 +- {PLAN_PEAK_TOL})")
    check(abs(ratio - 1) <= PLAN_PEAK_TOL,
          f"plan {label}: peak {peak} against {want_peak} planned")
    del state, tokens, step
    return dict(args_bytes=want, args_allocated=args_alloc, peak=peak,
                planned_peak=want_peak, peak_ratio=ratio, step_s=times,
                flop_share=shares)


def llama_plan_phase(args, torch, dev0):
    """27. llama3.2-1b's training cell (phase 12's) against its plan."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh

    cfg = get_config("llama3.2-1b")
    if args.small:
        cfg = replace(cfg, n_layers=2)
    shape = ShapeConfig("train_4096_batch8", TRAIN["seq"], TRAIN["batch"],
                        "train", accum_steps=TRAIN["batch"])
    rec = D.plan(cfg, shape, make_test_mesh(1))
    return plan_against_card(torch, dev0, cfg, shape, rec, cfg.name)


def mla_bwd_phase(args, torch, dev0):
    """28. ``flash_attention_bwd`` at MLA's head dim against its plain
    version; the timed shape's measurements."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    m = cfg.mla
    H, D = cfg.n_heads, m.nope_head_dim + m.rope_head_dim
    gen_t = torch.Generator(dev0).manual_seed(12)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    log(f"flash_attention_bwd at MLA's head dim {D} against its plain "
        f"version:")
    S = 1024 if args.small else TRAIN["seq"]
    res = attn_bwd_check(torch, randn, 1, S, H, H, D, bf16, timed=True,
                         by_kernel=True)
    # bfloat16 at 192 runs the wgmma kernels, never the float32 FMAs
    want = {"bwd_dsum_bf16_kernel", f"bwd_dkdv_split_kernel<{D}>",
            f"bwd_dq_wgmma_kernel<{D}>"}
    check(set(res["kernels_ms"]) == want,
          f"flash_attention_bwd at D = {D}: kernels "
          f"{sorted(res['kernels_ms'])}, expected {sorted(want)}")
    attn_bwd_check(torch, randn, 2, 1000, H, H, D, bf16)       # ragged S
    attn_bwd_check(torch, randn, 1, 1000, H, H, D, f32)
    attn_bwd_check(torch, randn, 2, 77, 4, 2, D, bf16)         # G = 2
    attn_bwd_check(torch, randn, 2, 77, 4, 2, D, f32)
    res.update(v_width_bwd(torch, randn, S, H, D, m.v_head_dim))
    return res


def v_width_bwd(torch, randn, S, H, D, DV):
    """MLA's model calls the forward with v at DV < D columns: under
    autograd its gradients must be bitwise those of the backward kernel
    on v, the output and its gradient zero-padded to D (dv cut back).
    Times ``flash_attention_bwd`` given the DV-wide tensors (it pads them)
    against the same call on tensors padded beforehand: the padding's
    cost.  Returns both times for the record."""
    from repro_torch.kernels.flash_attention import kernel as KA
    F = torch.nn.functional
    bf16 = torch.bfloat16
    q, k = randn((1, S, H, D), bf16), randn((1, S, H, D), bf16)
    v, dout = randn((1, S, H, DV), bf16), randn((1, S, H, DV), bf16)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = KA.flash_attention(qg, kg, vg)
    got = torch.autograd.grad(out, (qg, kg, vg), dout)
    out = out.detach()
    lse = KA.flash_attention_fwd(q, k, v, keep_lse=True)[1]
    vp, outp, doutp = (F.pad(t, (0, D - DV)) for t in (v, out, dout))
    want = KA.flash_attention_bwd(q, k, vp, outp, doutp, lse)
    shape = f"B=1 S={S} H=KH={H} D={D} Dv={DV} bf16"
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(torch.equal(g, w[..., :g.shape[-1]]),
              f"flash_attention {shape}: autograd's {name} differs from "
              f"the backward on the zero-padded inputs")
    ms = cuda_ms(lambda: KA.flash_attention_bwd(q, k, v, out, dout, lse),
                 torch)
    padded_ms = cuda_ms(lambda: KA.flash_attention_bwd(q, k, vp, outp,
                                                       doutp, lse), torch)
    log(f"  flash_attention {shape} under autograd: gradients bitwise "
        f"those of the padded backward; flash_attention_bwd at Dv {ms:.4f}"
        f" ms, on inputs padded beforehand {padded_ms:.4f} ms (the "
        f"padding {ms - padded_ms:.4f} ms)")
    del q, k, v, dout, qg, kg, vg, out, got, lse, vp, outp, doutp, want
    torch.cuda.empty_cache()
    return {"v_width_ms": ms, "v_padded_ms": padded_ms}


def deepseek_train_phases(args, torch, dev0):
    """29-30. deepseek-v2-lite-16b trained at full width on a cut depth,
    its rows chosen by the plan; card against host.  Returns (the
    training run's summary, the plan check's)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T

    free_card(torch, dev0, "deepseek training phases")
    full = get_config("deepseek-v2-lite-16b")
    cfg = replace(full, n_layers=DEEPSEEK_TRAIN["layers"])
    check([cfg.mlp_kind(i) for i in range(cfg.n_layers)]
          == ["dense", "moe", "moe"], "deepseek training: the cut's layers")
    S = 1024 if args.small else DEEPSEEK_TRAIN["seq"]
    total = torch.cuda.get_device_properties(dev0).total_memory
    for rows in range(DEEPSEEK_TRAIN["batch"], 0, -1):
        shape = ShapeConfig(f"train_{S}_batch{rows}", S, rows, "train",
                            accum_steps=rows)
        rec = D.plan(cfg, shape, make_test_mesh(1))
        # the state, and two groups each with a packet of one row in
        # flight and its gradients' sums
        need = rec["argument_bytes_allocated"] + 2 * rec["step_peak_bytes"]
        log(f"plan {cfg.name} ({cfg.n_layers} of {full.n_layers} layers) "
            f"x {rows} x {S}: arguments "
            f"{rec['argument_bytes_allocated'] / 1e9:.3f} GB, a packet "
            f"{rec['step_peak_bytes'] / 1e9:.3f} GB, two groups "
            f"{need / 1e9:.3f} GB of the card's {total / 1e9:.1f} GB "
            f"(fill limit {PLAN_FILL})")
        if need <= PLAN_FILL * total:
            break
    check(need <= PLAN_FILL * total, "deepseek training: no rows fit")
    card = plan_against_card(torch, dev0, cfg, shape, rec,
                             f"{cfg.name} ({cfg.n_layers} layers)")

    # ---------------- 29: train at full width, 3 layers, bf16, 2 groups
    params, summary = hetero_train(
        torch, dev0, cfg, S, rows, DEEPSEEK_TRAIN["steps"],
        f"{cfg.name} ({cfg.n_layers} of {full.n_layers} layers)",
        held_out=True)
    summary["flop_share"] = [rec["flops"] / t / BF16_OPS_S
                             for t in summary["step_times"]]
    log(f"train {cfg.name}: model-FLOP share a step "
        f"{[round(x, 4) for x in summary['flop_share']]} ({rec['flops']:.4e}"
        f" planned flops a step / step time / 989e12)")

    # --------------------- 30: card against host, f32, the first layers
    free_card(torch, dev0, "deepseek training parity")
    n = DEEPSEEK_PARITY_LAYERS
    p32 = T.LM(params.embed, list(params.layers[:n]), params.final_norm,
               params.lm_head).to(torch.float32)
    del params
    cfg32 = replace(cfg, n_layers=n, dtype="float32")
    batch = SyntheticPipeline(cfg32, ShapeConfig(
        "parity", TRAIN_PARITY_SEQ, 1, "train")).batch_at(0)
    train_card_against_host(torch, dev0, cfg32, p32, batch,
                            f"{cfg.name} ({n} layers)")
    del p32
    return summary, card


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
    anywhere, ``want`` on the host), or two dicts of tensors by name.
    Every element within 1e-3 of its parameter's largest |value|, except
    at most TRAIN_FLIPS of all elements, each within 2 lr more.  The
    differences are taken in float32 on ``got``'s device, a parameter at
    a time.  Returns (worst share of its tol, elements outside,
    elements)."""
    worst, outside, total = 0.0, 0, 0
    pairs = (((n, a), want[n]) for n, a in got.items()) if isinstance(
        got, dict) else zip(got.named_parameters(), want.parameters())
    for (n, a), b in pairs:
        a = a.detach().float()
        b = b.detach().to(a.device, torch.float32)
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
    from repro_torch.training.step import make_train_step

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
    train_card_against_host(torch, dev0, cfg32, p32,
                            SyntheticPipeline(cfg32, pshape).batch_at(0),
                            f"{cfg.name} ({n_par} layers)", opt=opt)

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


def attn_bwd_check(torch, randn, B, S, h, kh, d, dtype, timed=False,
                   by_kernel=False):
    """Hold ``flash_attention_bwd``, fed the log-sum-exp the forward
    keeps, against ``attention_bwd_ref`` on inputs from ``randn`` at
    ``ATTN_BWD_TOL``, two calls bitwise equal and equal to a call that
    has the forward write the log-sum-exp again; with ``timed``, time
    kernel, plain version and SDPA's backward and return the
    measurements for a kernel record; with ``by_kernel`` also each of
    the call's kernels' device time (``traced_window``, 5 calls), by
    kernel name, as ``kernels_ms``."""
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
        if by_kernel:
            rows = traced_window(torch, lambda: KA.flash_attention_bwd(
                q, k, v, out, dout, lse), 5)
            res["kernels_ms"] = {
                e.key.split("::")[-1].split("(")[0]: getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 5e3
                for e in rows if "bwd_" in e.key}
            log(f"  timed {shape}, device ms a call by kernel: "
                + ", ".join(f"{n} {t:.4f}"
                            for n, t in sorted(res["kernels_ms"].items())))
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
        check(len(bwd_mma) == 8, f"flash_attention_bwd: HGMMA in "
                                 f"{sorted(bwd_mma)}, expected the dK/dV "
                                 f"and dQ kernels at D = 64, 80, 128, 192")
        # the forward's instances by (D, Dv), MLA's (192, 128) among them
        fwd_mma = {k: n for k, n in counts.items()
                   if "flash_fwd_wgmma_kernel" in k}
        log("flash_attention SASS: HGMMA instructions " + ", ".join(
            f"{n} in {k[:60]}" for k, n in sorted(fwd_mma.items())))
        check(len(fwd_mma) == 5
              and any("ILi192ELi128E" in k for k in fwd_mma),
              f"flash_attention: HGMMA in {sorted(fwd_mma)}, expected the "
              f"wgmma forward at (D, Dv) = (64, 64), (80, 80), (128, 128), "
              f"(192, 128) and (192, 192)")
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


# ------------------------- the dense configs and dbrx served (31-34)
# (arch, layers served at full width (None: all of them), layers of the
# float32 card-against-host model, its kernel records' entry, seed).
# Each is served on an eighth to a quarter of its layers (dbrx-132b's 40
# are 263 GB, qwen3-32b's 64 65.5 GB; halved again when phases 47-49
# were added): a layer adds nothing the first ones do not check, and the
# script's time is bounded (PERF.md).  The float32 models are made fresh
# from the cut config (never a float32 copy of the served weights:
# qwen3's would be 131 GB):
# qwen3 2 layers with its 151,936-token embedding and head (10.1 GB a
# side), yi 4, stablelm 8, dbrx 2 (31 GB a side, 13 GB a layer)
SERVED_CONFIGS = (("qwen3-32b", 8, 2, "qwen3_shape", 8),
                  ("yi-9b", 12, 4, "yi_shape", 9),
                  ("stablelm-3b", 8, 8, "stablelm_shape", 10),
                  ("dbrx-132b", 2, 2, "dbrx_shape", 11))


def served_config_phase(args, torch, dev0, arch, n_layers, n_parity, seed):
    """Phases 31-34, one config each: hold ``flash_attention`` and
    ``flash_decode`` against their plain versions at the config's heads
    (the serving prefill and decode shapes in bfloat16, timed; a ragged S
    in float32), serve it at full width on ``n_layers`` layers (all of
    them where None; ``--small``: 2) through ``serve_model`` (one
    ``flash_attention`` launch a layer and prefill, one ``flash_decode``
    launch a layer and decode step), then hold a float32 model of its
    first ``n_parity`` layers, made fresh from the cut config, card
    against host (an MoE config with the routing equal).  Returns (the
    path's launches, the two kernels' measurements at its heads, the
    serving row)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    free_card(torch, dev0, f"{arch} phase")
    full = get_config(arch)
    n = 2 if args.small else (n_layers or full.n_layers)
    cfg = full if n == full.n_layers else replace(full, n_layers=n)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    P, gen, lws = (SERVE[k] for k in ("prompt", "gen", "lws"))
    bf16, f32 = torch.bfloat16, torch.float32
    gen_t = torch.Generator(dev0).manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"kernels at {arch}'s heads ({H} query heads over {KH}, G = "
        f"{H // KH}, D = {D}) against their plain versions:")
    attn = attn_check(torch, randn, lws, P, H, KH, D, bf16, timed=True)
    attn_check(torch, randn, 2, 1000, H, KH, D, f32)       # ragged S
    dec = decode_check(torch, randn, lws, P + gen, H, KH, D, P + gen - 1,
                       bf16, timed=True)
    decode_check(torch, randn, 3, 1000, H, KH, D, 700, f32)

    # -------------------------------- serve at full width, bfloat16
    if args.small:
        log(f"serve {arch}: {n} of its {full.n_layers} layers (--small)")
    elif n != full.n_layers:
        log(f"serve {arch}: depth cut to its first {n} of {full.n_layers} "
            f"layers at full width (the whole model: "
            f"{T.param_count(full)[0] * 2 / 1e9:.1f} GB of bfloat16 "
            f"weights; SERVED_CONFIGS says why)")
    params = make_params(torch, dev0, cfg)
    served = {}
    row = serve_model(torch, dev0, cfg, params, served,
                      per_prefill={"flash_attention": n},
                      per_step={"flash_decode": n})
    row.update(layers=n, of_layers=full.n_layers)
    del params
    free_card(torch, dev0, f"{arch} parity")

    # ------------- card against host, float32, a fresh cut model
    cut = replace(full, n_layers=min(n_parity, n), dtype="float32")
    p32 = T.init_params(cut, torch.Generator(dev0).manual_seed(seed))
    log(f"parity {arch}: a float32 model of its first {cut.n_layers} of "
        f"{full.n_layers} layers at full width, made from the cut config "
        f"({T.param_bytes(p32) / 1e9:.2f} GB on each side; host memory "
        f"and time)")
    compare = (routed_card_against_host if cut.moe.n_routed
               else card_against_host)
    compare(torch, dev0, cut, p32, f"{arch} ({cut.n_layers} layers)")
    del p32
    return served, attn, dec, row


def served_configs_phases(args, torch, dev0):
    """Phases 31-34 in turn; returns (launches by config, the kernels'
    entries by record key, the serving rows)."""
    paths, entries, rows = {}, {"flash_attention": {}, "flash_decode": {}}, {}
    for i, (arch, n_layers, n_parity, key, seed) in enumerate(
            SERVED_CONFIGS):
        stamp(f"phase {31 + i}: {arch}")
        paths[arch], a, d, rows[arch] = served_config_phase(
            args, torch, dev0, arch, n_layers, n_parity, seed)
        for name, r in (("flash_attention", a), ("flash_decode", d)):
            entries[name][key] = long_entry(r, f"{arch}'s heads")
    log("serving table: " + json.dumps(rows))
    return paths, entries, rows


# ---------------------- jamba-v0.1-52b served by four ranks (35-37)
# four ranks on the one card, as the ("data", "model") = (1, 4) mesh of the
# planner's h100x4, joined by gloo (NCCL refuses two ranks on one GPU)
SHARDED_WORLD = 4
SHARDED_PATH = "jamba-v0.1-52b sharded (1, 4)"
# phase 36: one period of 4 of the 32 layers at full width in bfloat16
# (13.8 GB, about a quarter of it a rank), the llama set-up's request
# shape: batch 4, prompt 256, 16 greedy tokens (32 before phases 47-49
# were added, for the script's time)
SHARDED_RUN = dict(batch=4, prompt=256, gen=16)
# phase 35: the ranks' float32 logits against the one-process card run
# (TF32 off), the tolerance of tests/test_torch_dense_configs.py
SHARDED_TOL = dict(rtol=2e-4, atol=2e-4)
# one rank set's limit: its weights made in turns, then its runs (a
# gloo all-reduce of four ranks on one card took 6.7-16.4 ms,
# gloo_times.py, PERF.md)
SHARDED_TIMEOUT_S = 600
# layer i's weights come from a generator seeded SHARDED_SEED * 1000 + i,
# the embedding, final norm and head from SHARDED_SEED * 1000 + n_layers
SHARDED_SEED = 11
# the ranks' allocator settings (their environment at spawn)
ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"


def run_ranks(torch, dev0, fn, *args):
    """``fn(rank, world, *args)`` on ``SHARDED_WORLD`` gloo ranks of
    ``dev0`` (``parallel/spmd.py``), the card's free blocks returned
    first; their results, rank 0 first.  The ranks take expandable
    segments: emptying a rank's cache after its turn then returns every
    free page, not only the segments no block holds (fragments kept 7 GB
    a rank, and phase 36 ran out of memory)."""
    import os
    import tempfile

    from repro_torch.parallel import spmd

    free_card(torch, dev0, f"before {SHARDED_WORLD} ranks")
    before = os.environ.get(ALLOC_CONF)
    os.environ[ALLOC_CONF] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as d:
            return spmd.run(fn, SHARDED_WORLD, store_dir=d, backend="gloo",
                            device=str(dev0), args=args,
                            timeout=SHARDED_TIMEOUT_S)
    finally:
        if before is None:
            del os.environ[ALLOC_CONF]
        else:
            os.environ[ALLOC_CONF] = before


def timed_run(torch, res):
    """A copy of the rank's ``res`` that adds each collective's time on
    the host clock (the backward's too), the card drained before and
    after it, to its ``seconds`` and, by kind (all-reduce, all-gather,
    reduce-scatter), to its ``by_kind``."""
    import dataclasses

    from repro_torch.parallel.collectives import ShardedRun

    class TimedRun(ShardedRun):
        seconds = 0.0

        def _timed(self, kind, fn, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = fn(*a)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            self.seconds += dt
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + dt
            return y

        def _reduce(self, x, op="sum", group=None):
            return self._timed("all-reduce", super()._reduce, x, op, group)

        def _gather(self, x, dim, group=None):
            return self._timed("all-gather", super()._gather, x, dim,
                               group)

        def _scatter(self, x, group):
            return self._timed("reduce-scatter", super()._scatter, x,
                               group)

    run = TimedRun(**{f.name: getattr(res, f.name)
                      for f in dataclasses.fields(res)})
    run.by_kind = {}
    return run


def seeded_params(torch, cfg, dev, res=None):
    """``cfg``'s weights on ``dev``, each layer drawn from a generator of
    its own (``SHARDED_SEED``), so that every rank can make its blocks of
    the one-process model's weights.  With ``res`` the rank's blocks
    (``transformer.shard_params``): the ranks of the process group make
    each layer whole in turn and cut it, so that one whole layer at a
    time is on the card."""
    import torch.distributed as dist

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def gen(i):
        return torch.Generator(dev).manual_seed(SHARDED_SEED * 1000 + i)

    def cut(module):
        return module if res is None else T.shard_params(cfg, module, res)

    dtype = getattr(torch, cfg.dtype)
    V, d = cfg.vocab_size, cfg.d_model
    g = gen(cfg.n_layers)
    top = cut(T.LM(L._dense_init(g, (V, d), dtype, V, scale=0.02), [],
                   L._ones(d, dtype, dev),
                   None if cfg.tie_embeddings
                   else L._dense_init(g, (d, V), dtype, d)))
    layers = []
    turns, me = ((1, 0) if res is None
                 else (dist.get_world_size(), dist.get_rank()))
    for i in range(cfg.n_layers):
        for turn in range(turns):
            if turn == me:
                layers.append(cut(T._layer_init(cfg, i, gen(i), dtype)))
                torch.cuda.synchronize(dev)
                # the whole layer's blocks back to the card, not to this
                # process's cache, before the next rank's turn
                torch.cuda.empty_cache()
            if res is not None:
                dist.barrier()
    return T.LM(top.embed, layers, top.final_norm, top.lm_head)


def teacher_forced(torch, cfg, params, tokens, prompt, dev, res=None,
                   patches=None, max_seq=None, batch=None):
    """Prefill ``prompt`` tokens of ``tokens`` (numpy (B, S), or (B, S, CB)
    with codebooks; ``patches`` numpy (B, n, d) for the ``vit_stub``
    frontend) into a cache of ``max_seq`` (S unless given), then one
    decode step each for the rest; the logits of each, stacked on the
    host.  ``batch``: the whole batch whose rows ``tokens`` are (B unless
    given: a rank's rows under a "data" axis above 1)."""
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        t = torch.as_tensor(tokens, device=dev)
        pt = None if patches is None else torch.as_tensor(patches,
                                                          device=dev)
        cache = T.init_cache(cfg, batch or t.shape[0],
                             max_seq or t.shape[1], dev, res=res)
        lg, cache = T.prefill(cfg, params, t[:, :prompt], cache, patches=pt,
                              res=res)
        outs = [lg[:, 0]]
        for i in range(prompt, t.shape[1]):
            lg, cache = T.decode_step(cfg, params, t[:, i:i + 1], cache, i,
                                      res=res)
            outs.append(lg[:, 0])
        return torch.stack(outs, dim=1).cpu()


def rank_setup(rank, world, cfg, train=False):
    """A rank's start: the kernels loaded (the parent built them: a rank
    that compiles fails), TF32 off, nothing of ``jax`` or ``repro``
    imported, and its ``res`` on the (1, ``world``) mesh (``train``: as
    ``sharded_run`` checks a training run)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.collectives import sharded_run

    build.load()
    check(build.build_seconds == 0.0, f"rank {rank} compiled the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = sharded_run(cfg, make_test_mesh(world), rank=rank,
                      group=dist.group.WORLD, train=train)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"rank {rank} imported {leaked}")
    return torch, res, torch.device("cuda", torch.cuda.current_device())


def sharded_serving_rank(rank, world, cut, ptoks, prompt, cfg, prompts,
                         gen):
    """Phases 35 and 36 on one rank, one spawn for both: the float32
    parity of ``cut``, then the bfloat16 greedy run of ``cfg``."""
    import gc

    import torch
    parity = sharded_parity_rank(rank, world, cut, ptoks, prompt)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(parity=parity,
                serve=sharded_serve_rank(rank, world, cfg, prompts, gen))


def sharded_parity_rank(rank, world, cfg, tokens, prompt):
    """Phase 35 on one rank: its float32 blocks of the parent's weights,
    the teacher-forced logits and every routing's chosen experts."""
    torch, res, dev = rank_setup(rank, world, cfg)
    params = seeded_params(torch, cfg, dev, res)
    with recorded_routes() as routes:
        logits = teacher_forced(torch, cfg, params, tokens, prompt, dev, res)
    return dict(logits=logits.numpy(), routes=[i.numpy() for _, i in routes],
                weights_gb=sum(p.numel() * p.element_size()
                               for p in params.parameters()) / 1e9)


def rank_kernel_ms(torch, fn, n, tries: int = 3):
    """This rank's kernel ms a call of ``fn`` over ``n`` calls: the
    device rows of a ``torch.profiler`` trace bracketed by spin kernels,
    as ``traced_window`` takes it.  ``fn`` joins the other ranks in its
    collectives, so every rank takes each trace together: a trace that
    lost a spin kernel on any rank is taken again on all of them, and
    one still lost after ``tries`` fails the phase."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            for _ in range(n):
                fn()
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum(e.count for e in events if "spin_kernel" in e.key)
        lost = torch.tensor([float(spins != 2)])
        dist.all_reduce(lost)          # gloo, on the host
        if not lost.item():
            break
        log(f"  rank trace {attempt + 1} of {tries}: {int(lost.item())} "
            f"ranks lost events (this one holds {spins} of the 2 spin "
            f"kernels)")
    check(not lost.item(), f"the ranks' profiler traces lost events "
          f"{tries} times")
    us = sum(e.self_device_time_total for e in events
             if "spin_kernel" not in e.key)
    check(us > 0, "a rank's profiler trace holds no kernel time")
    return us / n / 1e3


def sharded_serve_rank(rank, world, cfg, prompts, gen):
    """Phase 36 on one rank: its bfloat16 blocks of ``cfg`` made in
    turns, ``gen`` greedy tokens after ``prompts`` (launches counted from
    0 just before), a prefill's and a decode step's time (CUDA events), kernel
    time (busy share), peak memory, and on extra steps the collectives
    ``OpCost`` counts and the time spent in them."""
    torch, res, dev = rank_setup(rank, world, cfg)
    import torch.distributed as dist

    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, res)
    build_s = time.perf_counter() - t0
    B, P = prompts.shape
    batch = torch.as_tensor(prompts, device=dev)

    def greedy(n_tok):
        cache = T.init_cache(cfg, B, P + gen, dev, res=res)
        lg, cache = T.prefill(cfg, params, batch, cache, res=res)
        out = []
        for i in range(n_tok):
            out.append(lg[:, -1].argmax(-1, keepdim=True))
            if i + 1 < n_tok:
                lg, cache = T.decode_step(cfg, params, out[-1], cache, P + i,
                                          res=res)
        return torch.cat(out, dim=1)

    counters = counted_kernels()
    with torch.inference_mode():
        greedy(2)                               # first launches
        torch.cuda.synchronize()
        dist.barrier()
        for k in counters.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tokens = greedy(gen)
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        cache = T.init_cache(cfg, B, P + gen, dev, res=res)
        tok = tokens[:, :1].contiguous()

        def prefill(run=res):
            return T.prefill(cfg, params, batch, cache, res=run)

        def step(run=res):
            return T.decode_step(cfg, params, tok, cache, P + gen // 2,
                                 res=run)

        def event_ms(fn, reps):
            # no spin kernel first (cuda_ms): it would hold the card that
            # the other ranks share
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps

        prefill_ms, step_ms = event_ms(prefill, 3), event_ms(step, 10)
        dist.barrier()
        kernels = {"prefill": rank_kernel_ms(torch, prefill, 2),
                   "decode": rank_kernel_ms(torch, step, 5)}
        counted = {}
        for kind, fn in (("prefill", prefill), ("decode", step)):
            with op_cost.OpCost() as oc:
                fn()
            counted[kind] = oc.summary()["collectives"]

        coll_ms = {}
        for kind, fn in (("prefill", prefill), ("decode", step)):
            timed = timed_run(torch, res)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(timed)
            torch.cuda.synchronize()
            coll_ms[kind] = (timed.seconds * 1e3,
                             (time.perf_counter() - t0) * 1e3)
    return dict(tokens=tokens.cpu().numpy(), launches=launches,
                served_s=served_s, build_s=build_s, prefill_ms=prefill_ms,
                step_ms=step_ms, kernels_ms=kernels, peak_gb=peak_gb,
                weights_gb=T.param_bytes(params) / 1e9,
                collectives=counted, collective_ms=coll_ms)


def sharded_phases(args, torch, dev0):
    """Phases 35-37: jamba-v0.1-52b split over four ranks on the card
    (``parallel/spmd.py``, gloo; one spawn runs 35 and 36): float32
    parity of one period of 4 against the one-process card run (35), one
    period of 4 of its 32 layers at full width served greedily by the
    four ranks (36; cut from 8 layers for the script's time), the
    planner's
    collectives against the ranks' and the three kernels at the per-rank
    shapes (37).  Returns (each kernel's launches over the four ranks of
    phase 36, its record entry at the per-rank shapes)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.models import transformer as T

    world = SHARDED_WORLD
    full = get_config("jamba-v0.1-52b")
    # gloo gathers no CUDA tensor (its all_gather_into_tensor ended four
    # ranks on one card with SIGSEGV); through host memory it took 6.39
    # and 7.94 ms in two runs against 7.58 and 7.64 ms for an all-reduce
    # of a zero-filled buffer of the gathered size (gloo_times.py,
    # PERF.md): no faster, and it moves a quarter of the bytes
    log(f"sharded: {world} ranks on {dev0} over gloo; the logits' gather "
        f"through host memory, the all-reduces on the card's tensors")

    # ------------- phase 35: float32, one period of 4, ranks against one
    stamp("phase 35")
    cut = replace(full, dtype="float32", **JAMBA_PERIOD4)
    B2, P2, n_steps = (PARITY[k] for k in ("batch", "prompt", "steps"))
    ptoks = np.random.default_rng(1).integers(
        0, cut.vocab_size, (B2, P2 + n_steps)).astype(np.int32)
    p32 = seeded_params(torch, cut, dev0)
    log(f"sharded parity: {cut.name} as one period of 4 at full width, "
        f"{T.param_bytes(p32) / 1e9:.2f} GB in float32 on one process")
    with recorded_routes() as routes:
        want = teacher_forced(torch, cut, p32, ptoks, P2, dev0)
    del p32
    # one rank set runs phases 35 and 36
    cfg = replace(full, **JAMBA_PERIOD4)
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    B, P, gen = (SHARDED_RUN[k] for k in ("batch", "prompt", "gen"))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, dev0, sharded_serving_rank, cut, ptoks, P2,
                      cfg, prompts, gen)
    log(f"sharded ranks (phases 35-36): {time.perf_counter() - t0:.1f} s "
        f"with the spawn")
    got = [r["parity"] for r in ranks]
    top = float(want.abs().max())
    for r, g in enumerate(got):
        lg = torch.from_numpy(g["logits"])
        err = float((lg - want).abs().max())
        check(bool(torch.isfinite(lg).all()) and lg.shape == want.shape,
              f"sharded parity: rank {r}'s logits")
        torch.testing.assert_close(lg, want, **SHARDED_TOL)
        check(np.array_equal(g["logits"], got[0]["logits"]),
              f"sharded parity: rank {r}'s logits differ from rank 0's")
        check(len(g["routes"]) == len(routes) and all(
            np.array_equal(a, b.numpy())
            for a, (_, b) in zip(g["routes"], routes)),
            f"sharded parity: rank {r} routes tokens to other experts")
        log(f"sharded parity rank {r}: {g['weights_gb']:.2f} GB of float32 "
            f"weights; max |ranks - one process| {err:.3g} = "
            f"{err / top:.3g} of the largest logit {top:.3g} (rtol = atol "
            f"= 2e-4), {len(routes)} routings equal")

    # ------------- phase 36: one period of 4, bfloat16, four ranks, greedy
    stamp("phase 36")
    served = [r["serve"] for r in ranks]
    want_l = {"flash_attention": n_attn,
              "selective_scan_fused": cfg.n_layers - n_attn,
              "selective_scan": 0,
              "flash_decode": n_attn * (gen - 1)}
    for r, s in enumerate(served):
        check(np.array_equal(s["tokens"], served[0]["tokens"]),
              f"sharded serve: rank {r}'s tokens differ from rank 0's")
        check(s["launches"] == want_l, f"sharded serve: rank {r} launched "
              f"{s['launches']}, expected {want_l}")
        call_ms = {"prefill": s["prefill_ms"], "decode": s["step_ms"]}
        busy = {k: round(v / call_ms[k], 4)
                for k, v in s["kernels_ms"].items()}
        log(f"sharded serve rank {r}: {s['weights_gb']:.2f} GB of weights "
            f"made in {s['build_s']:.1f} s; {B} x {P} prompt + {gen} greedy "
            f"tokens in {s['served_s']:.3f} s; prefill {s['prefill_ms']:.3f}"
            f" ms, decode step {s['step_ms']:.3f} ms (CUDA events); kernel "
            f"ms a call {s['kernels_ms']}, busy {busy}; peak "
            f"{s['peak_gb']:.2f} GB; collectives a step "
            f"{json.dumps(s['collectives'])}; in collectives (ms, of the "
            f"step's ms, host clock, card drained around each) "
            f"{s['collective_ms']}")
    toks = served[0]["tokens"]
    check(toks.shape == (B, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"sharded serve: tokens of shape {toks.shape} out of range")
    log(f"sharded serve: {cfg.name} on {cfg.n_layers} of {full.n_layers} "
        f"layers, tokens equal on the {world} ranks; launches a rank "
        f"{want_l}")

    # ------------- phase 37: the planner against the ranks; the kernels
    stamp("phase 37")
    peak = max(s["peak_gb"] for s in served)
    for kind, seq in (("prefill", P), ("decode", P + gen)):
        rec = D.plan(cfg, ShapeConfig(f"sharded_{kind}", seq, B, kind),
                     card_mesh("h100x4"))
        check(rec["collectives"] == served[0]["collectives"][kind],
              f"plan {kind}: collectives {rec['collectives']} against the "
              f"card's {served[0]['collectives'][kind]}")
        even = rec["predicted_peak_bytes_per_device"] / 1e9
        own = rec["sharded_step"]["predicted_peak_bytes"] / 1e9
        log(f"plan h100x4 {kind} (batch {B}, seq {seq}): collectives equal "
            f"to the card run's, {json.dumps(rec['collectives'])}; "
            f"predicted peak a device {even:.2f} GB (even share), rank 0's "
            f"step {own:.2f} GB; measured peak of phase 36's run "
            f"{peak:.2f} GB")
    H, KH = cfg.n_heads // world, cfg.n_kv_heads // world
    D_, di = cfg.resolved_head_dim, cfg.d_inner // world
    bf16 = torch.bfloat16
    gen_t = torch.Generator(dev0).manual_seed(6)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log("kernels at the per-rank shapes against their plain versions:")
    shapes = {
        "flash_attention": attn_check(torch, randn, B, P, H, KH, D_, bf16,
                                      timed=True),
        "flash_decode": decode_check(torch, randn, B, P + gen, H, KH, D_,
                                     P + gen - 1, bf16, timed=True),
        "selective_scan": scan_kernel_check(torch, dev0, gen_t, B, P, di,
                                            cfg.ssm.d_state, timed=True),
        "selective_scan_fused": fused_scan_check(
            torch, dev0, gen_t, B, P, di, cfg.ssm.d_state, bf16,
            timed=True)}
    entries = {k: long_entry(r, f"{k}, a rank's share")
               for k, r in shapes.items()}
    launches = {k: sum(s["launches"][k] for s in served) for k in want_l}
    return launches, entries


# ------------------------ the served configs trained (phases 38-41)
# qwen3-32b, yi-9b, stablelm-3b and dbrx-132b trained at full width on
# TRAIN_4K's sequence: (arch, seed, parity layers; 0 where the host cannot
# hold a float32 copy of a layer with its moments, so the attention
# backward at the config's heads is held on the card instead; qwen3-32b's
# one layer: the host's float32 step of two took 43 s)
DENSE_TRAIN = (("qwen3-32b", 21, 1), ("yi-9b", 22, 2),
               ("stablelm-3b", 23, 2), ("dbrx-132b", 24, 0))
# each run: TRAIN_4K's 256 rows cut to 4 (a packet holds one or two of
# them: lws 1), 3 steps
DENSE_TRAIN_RUN = dict(rows=4, steps=3)
# the deepest cut trained, for the script's time (the plan fits 19 of
# yi-9b's 48 layers and all 32 of stablelm-3b's)
DENSE_TRAIN_MAX_LAYERS = 8
# AdamW at a tenth of TRAIN_OPT's rate: at 1e-3 qwen3-32b's held-out
# objective rose over 4 steps (12.43 -> 13.26, PERF.md)
DENSE_TRAIN_OPT = dict(TRAIN_OPT, lr=1e-4)


def dense_train_plan(torch, dev0, full, S):
    """The depth and the number of groups that the plan lets one card
    train ``full`` with: the deepest cut (at most
    ``DENSE_TRAIN_MAX_LAYERS``), with two groups where any depth fits
    with two, else one.  A step of ``HeteroDPTrainer`` holds the
    state (the plan's arguments), its bfloat16 sums of the packets'
    gradients (the parameters' bytes) and, on each group, one packet in
    flight (the plan's step of one row, ``make_train_step``): that must
    stay under ``PLAN_FILL`` of the card less what it holds already.  The
    plans of 1 and 2 layers reckon the first depth to plan (a layer adds
    its state, its sums and its gradients to each packet); the cut steps
    down from it until the plan fits, and up while the next one fits.
    Returns (the cut config, the packet's shape, its plan, the groups,
    the need in bytes)."""
    from dataclasses import replace

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T

    total = torch.cuda.get_device_properties(dev0).total_memory
    held = torch.cuda.memory_allocated(dev0)   # what earlier phases keep
    limit = PLAN_FILL * total - held
    shape = ShapeConfig(f"train_{S}_packet", S, 1, "train")
    plans = {}

    def need(n, groups):
        if n not in plans:
            cfg = replace(full, n_layers=n)
            rec = D.plan(cfg, shape, make_test_mesh(1))
            sums = T.param_bytes(T.init_abstract(cfg))
            plans[n] = (cfg, rec, sums)
            log(f"plan {full.name} ({n} of {full.n_layers} layers) x one "
                f"row of {S}: arguments "
                f"{rec['argument_bytes_allocated'] / 1e9:.3f} GB, a packet "
                f"{rec['step_peak_bytes'] / 1e9:.3f} GB, the gradients' "
                f"sums {sums / 1e9:.3f} GB; the step on meta in "
                f"{rec['meta_run_s']:.1f} s")
        _, rec, sums = plans[n]
        return rec["argument_bytes_allocated"] + sums + groups * rec[
            "step_peak_bytes"]

    for groups in (2, 1):
        one = need(1, groups)
        if one > limit:
            continue
        # a layer adds its state and sums, and its gradients to each
        # packet in flight
        two = min(2, full.n_layers)
        need(two, groups)
        per = (plans[two][1]["argument_bytes_allocated"]
               - plans[1][1]["argument_bytes_allocated"]
               + (1 + groups) * (plans[two][2] - plans[1][2]))
        top = min(full.n_layers, DENSE_TRAIN_MAX_LAYERS)
        n = top if per <= 0 else min(top, 1 + int((limit - one) // per))
        while n > 1 and need(n, groups) > limit:
            n -= 1
        while n < top and need(n + 1, groups) <= limit:
            n += 1
        cfg, rec, _ = plans[n]
        log(f"plan {full.name}: {n} of {full.n_layers} layers, {groups} "
            f"group(s): {need(n, groups) / 1e9:.3f} GB beside the "
            f"{held / 1e9:.3f} GB held, of the card's {total / 1e9:.1f} GB "
            f"(fill limit {PLAN_FILL})"
            + ("" if n == full.n_layers else
               f" (at most {DENSE_TRAIN_MAX_LAYERS} for the script's time)"
               if n == top else
               f"; {n + 1} layers would need "
               f"{need(n + 1, groups) / 1e9:.3f} GB"))
        return cfg, shape, rec, groups, need(n, groups)
    check(False, f"{full.name}: not one layer fits the card with one group")


def dense_train_phase(args, torch, dev0, arch, seed, n_parity):
    """One of phases 38-41: hold ``flash_attention`` and
    ``flash_attention_bwd`` against their plain versions at the config's
    heads (the backward timed beside SDPA's at B=1 S=4096), choose the
    depth and groups by the plan (``dense_train_plan``), hold the packet's
    plan against the card (``plan_against_card``), train the cut through
    ``HeteroDPTrainer`` (``hetero_train``: launches a packet, finite
    losses, a lower held-out objective), then, with ``n_parity``, a
    float32 step of its first layers card against host
    (``train_card_against_host`` with the AdamW step); without, the
    attention backward in float32 at a ragged S.  Returns (the training
    summary, the plan check, the timed backward)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import OptConfig

    free_card(torch, dev0, f"{arch} training phase")
    t0 = time.perf_counter()

    def mark(what):
        log(f"{arch}: {what} by {time.perf_counter() - t0:.1f} s into "
            f"the phase")

    full = get_config(arch)
    if args.small:
        full = replace(full, n_layers=2)
    S = 1024 if args.small else TRAIN["seq"]
    H, KH, D = full.n_heads, full.n_kv_heads, full.resolved_head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    gen_t = torch.Generator(dev0).manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log(f"attention at {arch}'s heads ({H}/{KH}, G = {H // KH}, D = {D}) "
        f"against its plain versions:")
    attn_check(torch, randn, 1, S, H, KH, D, bf16)
    bwd = attn_bwd_check(torch, randn, 1, S, H, KH, D, bf16, timed=True)
    attn_bwd_check(torch, randn, 2, 1000, H, KH, D, bf16)     # ragged S
    if not n_parity:
        attn_bwd_check(torch, randn, 1, 1000, H, KH, D, f32)

    mark("attention checked")
    cfg, shape, rec, groups, need = dense_train_plan(torch, dev0, full, S)
    label = f"{arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers)"
    mark("planned")
    card = plan_against_card(torch, dev0, cfg, shape, rec, label)
    free_card(torch, dev0, f"{arch} training")
    mark("the plan held against the card")
    rows = DENSE_TRAIN_RUN["rows"]
    held = torch.cuda.memory_allocated(dev0)
    params, summary = hetero_train(
        torch, dev0, cfg, S, rows, DENSE_TRAIN_RUN["steps"], label,
        held_out=True, groups=groups, opt=DENSE_TRAIN_OPT)
    summary.update(layers=cfg.n_layers, of_layers=full.n_layers,
                   groups=groups, rows=rows, tokens=rows * S,
                   planned_gb=need / 1e9,
                   peak_ratio=(summary["peak_gb"] * 1e9 - held) / need,
                   flop_share=[rec["flops"] * rows / t / BF16_OPS_S
                               for t in summary["step_times"]])
    log(f"train {label}: peak {summary['peak_gb']:.3f} GB "
        f"(max_memory_allocated; {held / 1e9:.3f} GB of it held before) "
        f"against {need / 1e9:.3f} GB planned for the state, the sums and "
        f"{groups} packet(s) in flight (measured/planned "
        f"{summary['peak_ratio']:.4f}); "
        f"model-FLOP share a step "
        f"{[round(x, 4) for x in summary['flop_share']]} ({rows} x "
        f"{rec['flops']:.4e} planned flops a row / step time / 989e12)")
    mark("trained")
    if n_parity:
        free_card(torch, dev0, f"{arch} training parity")
        n = min(n_parity, cfg.n_layers)
        p32 = T.LM(params.embed, list(params.layers[:n]), params.final_norm,
                   params.lm_head).to(f32)
        del params
        cfg32 = replace(cfg, n_layers=n, dtype="float32")
        batch = SyntheticPipeline(cfg32, ShapeConfig(
            "parity", TRAIN_PARITY_SEQ, 1, "train")).batch_at(0)
        train_card_against_host(torch, dev0, cfg32, p32, batch,
                                f"{arch} ({n} layers)",
                                opt=OptConfig(**DENSE_TRAIN_OPT))
        del p32
        mark("card against host")
    else:
        del params
    return summary, card, bwd


def dense_train_phases(args, torch, dev0):
    """Phases 38-41 in turn, on expandable segments; returns (training
    summaries, plan checks and the backward's entries at each config's
    heads, by config).  Each group's packets run on a stream of its own,
    whose cached blocks the other stream's allocations cannot take: with
    dbrx-132b's 45 GB of state beside what earlier phases keep, an H100
    ran out of memory with 10.7 GiB reserved but unallocated.  Expandable
    segments map the pages a stream frees where the other needs them."""
    from torch.cuda.memory import _set_allocator_settings

    runs, checks, entries = {}, {}, {}
    free_card(torch, dev0, "phases 38-41")
    _set_allocator_settings("expandable_segments:True")
    try:
        for i, (arch, seed, n_parity) in enumerate(DENSE_TRAIN):
            stamp(f"phase {38 + i}: {arch} trained")
            runs[arch], checks[arch], bwd = dense_train_phase(
                args, torch, dev0, arch, seed, n_parity)
            entries[arch] = long_entry(bwd, f"{arch}'s heads, backward")
    finally:
        _set_allocator_settings("expandable_segments:False")
    log("dense training table: " + json.dumps(
        {m: {k: r[k] for k in ("layers", "of_layers", "groups", "rows",
                               "tokens", "step_s", "tokens_s", "busy",
                               "peak_gb", "planned_gb", "peak_ratio")}
         for m, r in runs.items()}))
    return runs, checks, entries


# ------------- jamba-v0.1-52b trained by four ranks (phases 42-43)
SHARDED_TRAIN_PATH = "jamba-v0.1-52b sharded train (1, 4)"
# phase 43: phase 23's 2-layer cut at full width, one row of 2,048 tokens
# (the same row on every rank: "data" is 1), 3 AdamW steps with float32
# moments at phase 23's lr 1e-3: a rank holds 0.92 B parameters, 1.8 GB
# of bfloat16 weights, 1.8 GB of gradients and 7.4 GB of moments.  At lr
# 1e-4 the held-out objective rose (11.5985 -> 11.6113, PERF.md): an
# update of 1e-4 is about one bfloat16 step of a weight of 0.016
SHARDED_TRAIN_RUN = dict(batch=1, seq=2048, steps=3)
SHARDED_TRAIN_OPT = TRAIN_OPT
# phase 42: float32 ranks against one process, at the tolerances of
# tests/test_torch_train_dense.py: the loss (rtol), each gradient made
# whole (of its largest |g|), the gradients' norm (rtol)
SHARDED_TRAIN_TOL = dict(loss=1e-5, grad=1e-4, norm=1e-4)
# phase 43's peak of a rank against the plan's rank-0 peak
SHARDED_TRAIN_PEAK = (0.85, 1.15)


def rank_blocks(cfg, res, whole, tensors):
    """The rank's blocks (``transformer.shard_params``' cut) of
    ``tensors``, a dict by parameter name of ``whole``'s shapes."""
    from repro_torch.models import transformer as T
    axes = T.param_axes(cfg, whole)
    out = {}
    for n, t in tensors.items():
        owner, _, leaf = n.rpartition(".")
        out[n] = T._local(res, cfg, whole.get_submodule(owner), leaf,
                          axes[n], t).data
    return out


def grad_parity(torch, res, dev, cfg, batch):
    """Phase 42 on one rank.  The four ranks run the sharded float32 loss
    and gradients of their blocks of the weights (kept on the host); then,
    in turn, each rank runs the one-process loss and gradients of the
    whole model (``res`` None) and holds its blocks of them against its
    own.  Returns the losses, norms, each parameter's error relative to
    its whole gradient's largest |g|, and whether every routing was
    equal."""
    import torch.distributed as dist

    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.training.step import make_grad_fn

    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    params = seeded_params(torch, cfg, dev, res)
    params.requires_grad_(True)
    weights_gb = T.param_bytes(params) / 1e9
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with recorded_routes() as routes:
        (total, _), grads = make_grad_fn(cfg, res)(params, b)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    norm = float(adamw.global_norm(grads, res, T.split_names(cfg, res)))
    # the card holds one whole model and its gradients at a time
    grads = {n: g.cpu() for n, g in grads.items()}
    del params
    torch.cuda.empty_cache()
    for turn in range(res.size):
        if turn == res.rank:
            whole = seeded_params(torch, cfg, dev)
            whole.requires_grad_(True)
            t0 = time.perf_counter()
            with recorded_routes() as one_routes:
                (one_total, _), one = make_grad_fn(cfg)(whole, b)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one_norm = float(adamw.global_norm(one))
            errs = {}
            for n, ref in rank_blocks(cfg, res, whole, one).items():
                top = float(torch.linalg.vector_norm(one[n], math.inf))
                errs[n] = float((grads[n].to(dev) - ref).abs().max()) / max(
                    top, 1e-30)
                del ref
            del whole, one
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    same = len(routes) == len(one_routes) and all(
        torch.equal(a[1], c[1]) for a, c in zip(routes, one_routes))
    return dict(one_loss=float(one_total), loss=float(total),
                one_norm=one_norm, norm=norm, errs=errs, routes_equal=same,
                n_routes=len(routes), one_s=one_s, sharded_s=sharded_s,
                weights_gb=weights_gb)


def train_run(torch, res, dev, cfg, batches, held, steps, plan_peak):
    """Phase 43 (and 48) on one rank: its bfloat16 blocks made in turns,
    AdamW state, the held-out objective before and after ``steps`` steps
    of ``make_train_step(res=...)`` (launches counted from 0 just before,
    each step timed, the peak since the state was made; the first step's
    collectives counted by ``OpCost``, the last's each timed, by kind,
    the steps between them plain: ``step_ms``), then on one extra step
    its kernel time.  ``batches`` and ``held`` are whole batches: the
    step and the objective take the rank's rows of them."""
    import torch.distributed as dist

    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.training.step import make_loss_fn, make_train_step

    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, res)
    opt = OptConfig(**SHARDED_TRAIN_OPT)
    state = init_state(params, opt)
    build_s = time.perf_counter() - t0
    loss_fn = make_loss_fn(cfg, res)
    step = make_train_step(cfg, opt, res=res)

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    # the loss takes the rank's rows (all of them where "data" is 1)
    held_rows = {k: v[res.rows(len(v))] for k, v in held.items()}

    def objective():
        with torch.no_grad():
            return float(loss_fn(state.params, on_card(held_rows))[0])

    before = objective()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    read_counts(reset=True)
    timed = timed_run(torch, res)
    step_timed = make_train_step(cfg, opt, res=timed)
    step_s, losses = [], []
    for i, b in enumerate(batches[:steps]):
        fn = step_timed if i == steps - 1 else step
        t0 = time.perf_counter()
        if i == 0:
            with op_cost.OpCost() as oc:
                state, m = fn(state, on_card(b))
            counted = oc.summary()["collectives"]
        else:
            state, m = fn(state, on_card(b))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    after = objective()
    extra = on_card(batches[-1])

    def one_step():
        nonlocal state
        state, _ = step(state, extra)

    dist.barrier()
    kernel_ms = rank_kernel_ms(torch, one_step, 1)
    plain = step_s[1:-1] or step_s
    return dict(before=before, after=after, losses=losses, step_s=step_s,
                step_ms=1e3 * sum(plain) / len(plain), launches=launches,
                peak=peak, plan_peak=plan_peak, build_s=build_s,
                kernel_ms=kernel_ms, collectives=counted,
                collective_ms=(timed.seconds * 1e3, step_s[-1] * 1e3),
                collective_kinds_ms={k: v * 1e3 for k, v in
                                     timed.by_kind.items()},
                weights_gb=T.param_bytes(state.params) / 1e9)


def sharded_train_rank(rank, world, cfg32, parity_batch, cfg, batches, held,
                       steps, plan_peak):
    """Phases 42-43 on one rank, one spawn for both: :func:`grad_parity`
    of the float32 ``cfg32``, then :func:`train_run` of ``cfg``."""
    torch, res, dev = rank_setup(rank, world, cfg, train=True)
    t0 = time.perf_counter()
    parity = grad_parity(torch, res, dev, cfg32, parity_batch)
    torch.cuda.empty_cache()
    parity["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = train_run(torch, res, dev, cfg, batches, held, steps, plan_peak)
    train["s"] = time.perf_counter() - t0
    return dict(parity=parity, train=train)


def sharded_train_prepare(args, torch, dev0):
    """Phases 42-43's set-up in the parent: jamba-v0.1-52b's 2-layer cut,
    its float32 parity batch, the bfloat16 batches and the plan's
    ``h100x4`` rank-0 step.  Returns (the context
    :func:`sharded_train_finish` reads, the ranks' arguments of
    :func:`sharded_train_rank`)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import card_mesh

    full = get_config("jamba-v0.1-52b")
    # one microbatch: the row is the batch (the config accumulates 16)
    cfg = replace(full, accum_override=0, **JAMBA_TRAIN)
    log(f"sharded training: {cfg.name} on {cfg.n_layers} of "
        f"{full.n_layers} layers (attention + MoE, Mamba + MLP) at full "
        f"width, {SHARDED_WORLD} gloo ranks on {dev0}")
    # phase 42: float32 at 1 x 256 tokens, the ranks' gradients against
    # one process's; phase 43: bfloat16, 3 steps of 1 x 2,048 tokens
    cfg32 = replace(cfg, dtype="float32")
    parity_batch = SyntheticPipeline(cfg32, ShapeConfig(
        "parity", TRAIN_PARITY_SEQ, 1, "train")).batch_at(0)
    B, S, steps = (SHARDED_TRAIN_RUN[k] for k in ("batch", "seq", "steps"))
    if args.small:
        S = 512
    shape = ShapeConfig("sharded_train", S, B, "train")
    pipe = SyntheticPipeline(cfg, shape, DataConfig(seed=TRAIN["seed"]))
    batches = [pipe.batch_at(i) for i in range(steps)]
    held = pipe.batch_at(steps + 1)
    rec = D.plan(cfg, shape, card_mesh("h100x4"))
    own = rec["sharded_step"]
    check("refused" not in own, f"plan h100x4 train: {own.get('refused')}")
    ctx = dict(cfg=cfg, B=B, S=S, steps=steps, rec=rec, own=own)
    return ctx, (cfg32, parity_batch, cfg, batches, held, steps,
                 own["predicted_peak_bytes"])


def sharded_train_finish(args, torch, dev0, ctx, out):
    """Phases 42-43's checks of the ranks' results ``out`` (the module's
    phases: 42, the float32 loss, every gradient made whole and the
    gradients' norm of the ranks against one process, at 1 x 256 tokens;
    43, 3 bfloat16 steps at 1 x 2,048 tokens: launches, step time, busy
    share, peaks against the plan's rank-0 step, the plan's collectives
    against the card's, the held-out objective), then the two attention
    kernels and the two scan kernels at a rank's shapes against their
    plain versions.  Returns (each kernel's launches over the four ranks
    of phase 43, its record entry at a rank's shapes)."""
    world = SHARDED_WORLD
    cfg, B, S, steps, rec, own = (ctx[k] for k in (
        "cfg", "B", "S", "steps", "rec", "own"))
    got = [o["parity"] for o in out]
    runs = [o["train"] for o in out]
    log(f"sharded training: phase 42 {max(g['s'] for g in got):.1f} s and "
        f"phase 43 {max(t['s'] for t in runs):.1f} s on the ranks")

    # ----------- phase 42: float32, the ranks' gradients against one
    tol = SHARDED_TRAIN_TOL
    for r, g in enumerate(got):
        rel = abs(g["loss"] - g["one_loss"]) / abs(g["one_loss"])
        worst = max(g["errs"].items(), key=lambda kv: kv[1])
        nrel = abs(g["norm"] - g["one_norm"]) / g["one_norm"]
        log(f"sharded train parity rank {r} (float32, TF32 off, 1 x "
            f"{TRAIN_PARITY_SEQ}): {g['weights_gb']:.2f} GB of weights; "
            f"loss {g['loss']:.7f} against one process's "
            f"{g['one_loss']:.7f} ({rel:.3g} relative, limit "
            f"{tol['loss']}); every gradient made whole within "
            f"{worst[1]:.3g} of its largest |g| ({worst[0]}; limit "
            f"{tol['grad']}); norm {g['norm']:.6f} against "
            f"{g['one_norm']:.6f} ({nrel:.3g}, limit {tol['norm']}); "
            f"{g['n_routes']} routings equal: {g['routes_equal']}; one "
            f"process {g['one_s']:.2f} s, the ranks {g['sharded_s']:.2f} s")
        check(math.isfinite(g["loss"]) and rel <= tol["loss"],
              f"sharded train parity: rank {r}'s loss {g['loss']} against "
              f"one process's {g['one_loss']} ({rel:.3g} relative)")
        check(worst[1] <= tol["grad"], f"sharded train parity: rank {r}'s "
              f"{worst[0]} gradient {worst[1]:.3g} of its largest away")
        check(nrel <= tol["norm"], f"sharded train parity: rank {r}'s "
              f"norm {g['norm']} against {g['one_norm']}")
        check(g["routes_equal"] and g["n_routes"] > 0,
              f"sharded train parity: rank {r} routes tokens to other "
              f"experts than one process")
        check(g["loss"] == got[0]["loss"] and g["norm"] == got[0]["norm"],
              f"sharded train parity: rank {r}'s loss or norm differs "
              f"from rank 0's")

    # ----------- phase 43: bfloat16, 3 steps of 1 x 2,048 tokens
    want_l = {k: v * steps for k, v in per_packet(cfg).items()}
    lo, hi = SHARDED_TRAIN_PEAK
    for r, t in enumerate(runs):
        ratio = t["peak"] / t["plan_peak"]
        step_ms = t["step_ms"]
        log(f"sharded train rank {r}: {t['weights_gb']:.2f} GB of weights "
            f"made with their moments in {t['build_s']:.1f} s; losses "
            f"{[round(x, 4) for x in t['losses']]}; step s "
            f"{[round(x, 3) for x in t['step_s']]} (the plain step "
            f"{step_ms:.1f} ms, {B * S / step_ms * 1e3:.0f} tokens/s "
            f"a rank set); kernel ms a step {t['kernel_ms']:.1f}, busy "
            f"{t['kernel_ms'] / step_ms:.1%}; in collectives "
            f"{t['collective_ms'][0]:.1f} ms of the timed step's "
            f"{t['collective_ms'][1]:.1f} ms (host clock, card drained "
            f"around each); peak {t['peak'] / 1e9:.3f} GB against the "
            f"plan's rank-0 {t['plan_peak'] / 1e9:.3f} GB ({ratio:.4f}, "
            f"limits {lo}-{hi}); held-out objective {t['before']:.6f} -> "
            f"{t['after']:.6f}; launches {t['launches']}; collectives a "
            f"step {json.dumps(t['collectives'])}")
        check(t["launches"] == want_l, f"sharded train: rank {r} launched "
              f"{t['launches']}, expected {want_l}")
        check(all(math.isfinite(x) for x in t["losses"])
              and t["after"] < t["before"],
              f"sharded train: rank {r}'s losses {t['losses']}, held-out "
              f"objective {t['before']} -> {t['after']}")
        check(t["losses"] == runs[0]["losses"], f"sharded train: rank {r}'s "
              f"losses differ from rank 0's")
        check(lo <= ratio <= hi, f"sharded train: rank {r}'s peak "
              f"{t['peak'] / 1e9:.3f} GB against the plan's "
              f"{t['plan_peak'] / 1e9:.3f} GB ({ratio:.4f})")
        check(t["collectives"] == rec["collectives"],
              f"sharded train: rank {r} counted {t['collectives']}, the "
              f"plan {rec['collectives']}")
    log(f"plan h100x4 train (batch {B}, seq {S}, {cfg.n_layers} layers): "
        f"collectives equal to each rank's counted step, "
        f"{json.dumps(rec['collectives'])}; rank 0's arguments "
        f"{rec['argument_bytes_per_device'] / 1e9:.3f} GB, its predicted "
        f"peak {own['predicted_peak_bytes'] / 1e9:.3f} GB (even share "
        f"{rec['predicted_peak_bytes_per_device'] / 1e9:.3f} GB)")

    H, KH = cfg.n_heads // world, cfg.n_kv_heads // world
    D_, di = cfg.resolved_head_dim, cfg.d_inner // world
    gen_t = torch.Generator(dev0).manual_seed(12)

    def randn(shape_, dtype):
        return torch.randn(shape_, generator=gen_t, device=dev0).to(dtype)

    log("training kernels at a rank's shapes against their plain versions:")
    bf16 = torch.bfloat16
    shapes = {
        "flash_attention": attn_check(torch, randn, B, S, H, KH, D_, bf16,
                                      timed=True),
        "flash_attention_bwd": attn_bwd_check(torch, randn, B, S, H, KH, D_,
                                              bf16, timed=True),
        "selective_scan": scan_kernel_check(torch, dev0, gen_t, B, S, di,
                                            cfg.ssm.d_state, timed=True),
        "selective_scan_bwd": scan_bwd_check(torch, dev0, gen_t, B, S, di,
                                             cfg.ssm.d_state, timed=True),
        "selective_scan_fused": fused_scan_check(
            torch, dev0, gen_t, B, S, di, cfg.ssm.d_state, bf16,
            timed=True),
        "selective_scan_fused_bwd": fused_scan_bwd_check(
            torch, dev0, gen_t, B, S, di, cfg.ssm.d_state, bf16,
            timed=True)}
    entries = {k: long_entry(r, f"{k}, a rank's training share")
               for k, r in shapes.items()}
    launches = {k: sum(t["launches"][k] for t in runs) for k in want_l}
    return launches, entries


# ----- caches split by positions on the (1, 4) mesh (phases 44-46)
# internvl2-1b (14/2 heads: neither splits over four ranks, so its GQA
# cache does) and deepseek-v2-lite-16b (MLA: its latent cache has no
# heads) served by four ranks; launches_by_path keys
KVSEQ_PATHS = {"internvl2-1b": "internvl2-1b kv_seq split (1, 4)",
               "deepseek-v2-lite-16b": "deepseek-v2-lite-16b kv_seq split "
                                       "(1, 4)"}
# phase 45, float32: a cache of 96 (stretches of 24), a prompt of 64
# (ranks 0 and 1 full, rank 2 two thirds, rank 3 empty) and 12 decode
# steps, which cross into rank 3 at position 72 (24 before phases 47-49
# were added, for the script's time)
KVSEQ_PARITY = dict(batch=2, max_seq=96, prompt=64, steps=12)
# deepseek-v2-lite-16b's parity depth: the dense layer and one MoE layer
# (4.5 GB of float32 in one process)
KVSEQ_DEEPSEEK_PARITY_LAYERS = 2
# phase 46, bfloat16 greedy: batch 4, a cache of 288 (stretches of 72),
# a prompt of 208 (rank 3 empty), 16 tokens, the last 8 decoded with
# position 216 on rank 3
KVSEQ_RUN = dict(batch=4, max_seq=288, prompt=208, gen=16)
# deepseek-v2-lite-16b served on 4 of its 27 layers (the dense one and 3
# MoE layers, 3.2 GB of bfloat16 weights): its decode step carries 5-6
# gloo collectives a layer, 6.7-16.4 ms each on one card (PERF.md)
KVSEQ_DEEPSEEK_LAYERS = 4
# internvl2-1b on 12 of its 24 layers in phases 45 and 46 (whole before
# phases 47-49 were added, for the script's time): its decode step
# carries 3 gloo all-reduces a layer
KVSEQ_VLM_LAYERS = 12
# phase 44: a rank's stretch at internvl2-1b's heads (B, H, KH, D) and
# (stretch rows, live rows); the last two take several splits, merged in
# the kernel (decode_32k's stretch of 8,192)
KVSEQ_HEADS = (4, 14, 2, 64)
KVSEQ_STRETCHES = ((72, 72), (72, 41), (72, 0), (8192, 8192), (8192, 5000))
# the kept log-sum-exp against the plain version's (float32 sums of the
# same products in another order)
LSE_TOL = dict(rtol=1e-4, atol=1e-4)
# a decode step's peak on a rank against the plan's rank-0 decode step
KVSEQ_PEAK = (0.85, 1.15)


def live_rows(pos, start, n):
    """The rows of a stretch of ``n`` positions from ``start`` at or
    before ``pos`` (0 for a stretch that starts past it)."""
    return min(max(pos + 1 - start, 0), n)


def stacked_ranks():
    """Four ranks' partials in one process: a ``ShardedRun`` whose
    collectives reduce over the tensors' leading dim, the rank (phase
    44's ``combine_lse`` against the whole cache)."""
    from repro_torch.parallel.collectives import ShardedRun

    class Stacked(ShardedRun):
        def _reduce(self, x, op="sum"):
            y = x.amax(0) if op == "max" else x.sum(0)
            return y.expand_as(x)

    return Stacked(None, {"model": 0})


def lse_check(torch, randn, S, n, dtype, timed=False):
    """Hold ``flash_decode_partial`` against ``decode_attention_partial``
    at internvl2-1b's heads on a stretch of ``S`` rows, ``n`` of them
    live: o at ``ATTN_TOL``, the log-sum-exp at ``LSE_TOL``, o rounded to
    bfloat16 bitwise equal to ``flash_decode``'s output (the lse pointer
    changes nothing else); an empty stretch launches nothing and gives 0
    and -inf.  With ``timed``: kernel, plain version and SDPA over the
    live rows, for the kernel's record."""
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    F = torch.nn.functional
    B, h, kh, d = KVSEQ_HEADS
    q = randn((B, h, d), dtype)
    kc, vc = randn((B, S, kh, d), dtype), randn((B, S, kh, d), dtype)
    before = KD.launches
    o, lse = KD.flash_decode_partial(q, kc, vc, n)
    torch.cuda.synchronize()
    shape = f"B={B} S={S} n={n} H={h} KH={kh} D={d} {dtype}"
    check(o.dtype == lse.dtype == torch.float32
          and o.shape == (B, h, d) and lse.shape == (B, h),
          f"flash_decode_partial {shape}: o {o.dtype} {tuple(o.shape)}, "
          f"lse {lse.dtype} {tuple(lse.shape)}")
    if n == 0:
        check(KD.launches == before and not o.any()
              and bool((lse == -math.inf).all()),
              f"flash_decode_partial {shape}: an empty stretch launched "
              f"{KD.launches - before} or gave o != 0, lse != -inf")
        log(f"  flash_decode_partial {shape}: no launch, o 0, lse -inf")
        return None
    check(KD.launches == before + 1, f"flash_decode_partial {shape}: "
          f"{KD.launches - before} launches")
    want_o, want_lse = RD.decode_attention_partial(q, kc, vc, n)
    rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(o, want_o, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    same = KD.flash_decode(q, kc, vc, n - 1)
    check(torch.equal(o.to(dtype), same), f"flash_decode_partial {shape}: "
          f"o differs from flash_decode's output")
    err = float((o - want_o).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    log(f"  flash_decode_partial {shape}: max abs err o {err:.3g}, lse "
        f"{lse_err:.3g}; o in {dtype} bitwise flash_decode's")
    if not timed:
        return None
    ms = cuda_ms(lambda: KD.flash_decode_partial(q, kc, vc, n), torch)
    plain_ms = cuda_ms(lambda: RD.decode_attention_partial(q, kc, vc, n),
                       torch, 1)
    qt = q[:, :, None]
    kt, vt = (c[:, :n].transpose(1, 2).contiguous() for c in (kc, vc))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), torch)
    elt = kc.element_size()
    res = dict(err=err, shape=shape, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               nbytes=elt * (2 * B * n * kh * d + B * h * d)
               + 4 * (B * h * d + B * h),
               ops=4.0 * B * h * d * n,
               ops_per_s=BF16_OPS_S if dtype == torch.bfloat16
               else FP32_OPS_S)
    log(f"  timed {shape}: kernel {ms:.4f} ms, SDPA {library_ms:.4f} ms, "
        f"kernel/SDPA {ms / library_ms:.3f}")
    return res


def combine_check(torch, randn, S, pos, dtype):
    """Four stretches of ``S`` rows, each rank's ``flash_decode_partial``
    over its live rows, joined by ``ShardedRun.combine_lse`` in one
    process, against ``flash_decode`` over the whole cache: the largest
    error."""
    from repro_torch.kernels.flash_decode import kernel as KD

    B, h, kh, d = KVSEQ_HEADS
    q = randn((B, h, d), dtype)
    kc, vc = (randn((B, 4 * S, kh, d), dtype) for _ in range(2))
    # each rank holds its stretch as a tensor of its own
    parts = [KD.flash_decode_partial(
        q, kc[:, r * S:(r + 1) * S].contiguous(),
        vc[:, r * S:(r + 1) * S].contiguous(), live_rows(pos, r * S, S))
        for r in range(4)]
    got = stacked_ranks().combine_lse(
        torch.stack([p[0] for p in parts]),
        torch.stack([p[1] for p in parts]), dtype)
    want = KD.flash_decode(q, kc, vc, pos)
    check(all(torch.equal(got[r], got[0]) for r in range(4)),
          "combine: the four ranks' results differ")
    rtol, atol = ATTN_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got[0].float(), want.float(), rtol=rtol,
                               atol=atol)
    err = float((got[0].float() - want.float()).abs().max())
    empty = sum(r * S > pos for r in range(4))
    log(f"  combine of 4 stretches of {S} at pos {pos} ({empty} empty), "
        f"{dtype}: max abs err against flash_decode over the whole cache "
        f"{err:.3g}")
    return err


def kvseq_kernel_phase(torch, dev0):
    """Phase 44: ``flash_decode_partial`` against its plain version (full,
    partly live and empty stretches, one split and several, bfloat16 and
    float32), four stretches combined against ``flash_decode`` over the
    whole cache, and the kernel timed at phase 46's stretch (PERF.md row
    6G4).  Returns its record entry."""
    gen_t = torch.Generator(dev0).manual_seed(44)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_t, device=dev0).to(dtype)

    log("flash_decode_partial against its plain version:")
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (S, n) in enumerate(KVSEQ_STRETCHES):
            r = lse_check(torch, randn, S, n, dtype,
                          timed=i == 0 and dtype == torch.bfloat16)
            timed = timed or r
    errs = [combine_check(torch, randn, S, pos, dtype)
            for dtype in (torch.bfloat16, torch.float32)
            for S, pos in ((72, 5), (72, 150), (72, 287), (2048, 7000))]
    log(f"combine: largest error over {len(errs)} cases {max(errs):.3g}")
    torch.cuda.empty_cache()
    return long_entry(timed, "flash_decode_partial, a rank's stretch")


def kvseq_cfgs(deepseek_layers, dtype, small=False, vlm_layers=None):
    """The two configs at ``dtype``: internvl2-1b on ``vlm_layers`` (whole
    unless given; 4 layers with ``small``), deepseek-v2-lite-16b at full
    width on its first ``deepseek_layers``."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    vlm = get_config("internvl2-1b")
    return {"internvl2-1b": replace(vlm, dtype=dtype, n_layers=4 if small
                                    else vlm_layers or vlm.n_layers),
            "deepseek-v2-lite-16b": replace(
                get_config("deepseek-v2-lite-16b"), dtype=dtype,
                n_layers=deepseek_layers)}


def cache_layout(cfg, res, max_seq):
    """(the rank's stretch of layer 0's first cache entry, the position
    lengths of every entry of the rank's cache)."""
    from repro_torch.models import transformer as T

    meta = T.init_cache(cfg, 1, max_seq, device="meta")
    name, axes = next(iter(T.cache_axes(cfg, meta)[0].items()))
    own = T.init_cache(cfg, 1, max_seq, device="meta", res=res)
    return (res.kv_stretch(axes, meta[0][name].shape),
            sorted({t.shape[1] for c in own for t in c.values()}))


def kvseq_serve(torch, res, dev, cfg, prompts, max_seq, gen):
    """Phase 46 (and 49) for one config on one rank: its bfloat16 blocks
    made in turns; ``gen`` greedy tokens after the rank's rows of
    ``prompts`` (all of them where "data" is 1) into a cache of
    ``max_seq`` (launches counted from 0 just before, the peak since);
    then on a fresh cache a decode step's time (CUDA events), its peak,
    the collectives ``OpCost`` counts in a prefill and a decode step and
    the decode step's time in them, by kind.  The peaks leave out what
    the rank held before it made these weights (``held``: earlier
    phases' cuBLAS workspaces on a rank set that runs several phases),
    which no plan of this step holds."""
    import torch.distributed as dist

    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T

    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, res)
    build_s = time.perf_counter() - t0
    B, P = prompts.shape
    batch = torch.as_tensor(prompts[res.rows(B)], device=dev)

    def greedy(n_tok):
        cache = T.init_cache(cfg, B, max_seq, dev, res=res)
        lg, cache = T.prefill(cfg, params, batch, cache, res=res)
        out = []
        for i in range(n_tok):
            out.append(lg[:, -1].argmax(-1, keepdim=True))
            if i + 1 < n_tok:
                lg, cache = T.decode_step(cfg, params, out[-1], cache, P + i,
                                          res=res)
        return torch.cat(out, dim=1)

    counters = counted_kernels()
    with torch.inference_mode():
        greedy(2)                               # first launches
        torch.cuda.synchronize()
        dist.barrier()
        for k in counters.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tokens = greedy(gen)
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) - held

        cache = T.init_cache(cfg, B, max_seq, dev, res=res)
        T.prefill(cfg, params, batch, cache, res=res)
        tok = tokens[:, :1].contiguous()
        pos = P + gen // 2

        def step(run=res):
            return T.decode_step(cfg, params, tok, cache, pos, res=run)

        step()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            step()
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / 3
        step_peak = torch.cuda.max_memory_allocated(dev) - held
        counted = {}
        with op_cost.OpCost() as oc:
            T.prefill(cfg, params, batch, cache, res=res)
        counted["prefill"] = oc.summary()["collectives"]
        with op_cost.OpCost() as oc:
            step()
        counted["decode"] = oc.summary()["collectives"]
        timed = timed_run(torch, res)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(timed)
        torch.cuda.synchronize()
        coll_ms = (timed.seconds * 1e3, (time.perf_counter() - t0) * 1e3)
    out = dict(tokens=tokens.cpu().numpy(), launches=launches,
               served_s=served_s, build_s=build_s, peak=peak,
               step_ms=step_ms, step_peak=step_peak, collectives=counted,
               collective_ms=coll_ms, layout=cache_layout(cfg, res, max_seq),
               collective_kinds_ms={k: v * 1e3 for k, v in
                                    timed.by_kind.items()}, held=held,
               weights_gb=T.param_bytes(params) / 1e9)
    del params, cache
    torch.cuda.empty_cache()
    return out


def kvseq_rank(rank, world, parity, serve):
    """Phases 45-46 on one rank, one spawn for both.  ``parity``: by arch,
    (float32 cfg, tokens) for :func:`teacher_forced` on a cache of
    ``KVSEQ_PARITY``'s; ``serve``: by arch, (bfloat16 cfg, prompts) for
    :func:`kvseq_serve`."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.collectives import sharded_run

    first = next(iter(parity.values()))[0]
    torch, _, dev = rank_setup(rank, world, first)
    mesh = make_test_mesh(world)
    got = {"parity": {}, "serve": {}}
    p = KVSEQ_PARITY
    for arch, (cfg, tokens) in parity.items():
        t0 = time.perf_counter()
        res = sharded_run(cfg, mesh, rank=rank, group=dist.group.WORLD)
        params = seeded_params(torch, cfg, dev, res)
        with recorded_routes() as routes:
            logits = teacher_forced(torch, cfg, params, tokens, p["prompt"],
                                    dev, res, max_seq=p["max_seq"])
        got["parity"][arch] = dict(
            logits=logits.numpy(), routes=[i.numpy() for _, i in routes],
            layout=cache_layout(cfg, res, p["max_seq"]),
            weights_gb=sum(t.numel() * t.element_size()
                           for t in params.parameters()) / 1e9,
            s=time.perf_counter() - t0)
        del params
        torch.cuda.empty_cache()
    r = KVSEQ_RUN
    for arch, (cfg, prompts) in serve.items():
        t0 = time.perf_counter()
        res = sharded_run(cfg, mesh, rank=rank, group=dist.group.WORLD)
        got["serve"][arch] = kvseq_serve(torch, res, dev, cfg, prompts,
                                         r["max_seq"], r["gen"])
        got["serve"][arch]["s"] = time.perf_counter() - t0
    return got


def kvseq_launches(cfg, rank, P, gen, max_seq):
    """Launches rank ``rank`` makes in a greedy run of ``gen`` tokens
    after a prompt of ``P``: every attention layer's ``flash_attention``
    once at the prefill, and for internvl2-1b's GQA one
    ``flash_decode_partial`` a layer at each of the ``gen`` - 1 decode
    steps whose position its stretch has reached (an empty stretch
    launches nothing; MLA's absorbed decode is plain products)."""
    n = cfg.n_layers
    n_rows = max_seq // SHARDED_WORLD
    steps = sum(live_rows(P + i, rank * n_rows, n_rows) > 0
                for i in range(gen - 1))
    return {"flash_attention": n, "selective_scan": 0,
            "selective_scan_fused": 0,
            "flash_decode": n * steps if cfg.attn_kind == "gqa" else 0}


def kvseq_prepare(args, torch, dev0):
    """Phases 44-46's work in the parent before the ranks: phase 44
    (:func:`kvseq_kernel_phase`), then the configs, tokens and the
    one-process float32 runs of phase 45.  Returns (the context
    :func:`kvseq_finish` reads, the ranks' arguments of
    :func:`kvseq_rank`)."""
    from repro_torch.models import transformer as T

    stamp("phase 44")
    entry = kvseq_kernel_phase(torch, dev0)

    p, r = KVSEQ_PARITY, KVSEQ_RUN
    cfg32 = kvseq_cfgs(KVSEQ_DEEPSEEK_PARITY_LAYERS, "float32", args.small,
                       KVSEQ_VLM_LAYERS)
    cfg16 = kvseq_cfgs(KVSEQ_DEEPSEEK_LAYERS, "bfloat16", args.small,
                       KVSEQ_VLM_LAYERS)
    rng = np.random.default_rng(45)
    parity = {a: (c, rng.integers(0, c.vocab_size, (
        p["batch"], p["prompt"] + p["steps"])).astype(np.int32))
        for a, c in cfg32.items()}
    serve = {a: (c, rng.integers(0, c.vocab_size, (
        r["batch"], r["prompt"])).astype(np.int32))
        for a, c in cfg16.items()}
    # the one-process float32 runs first, on the card alone
    want = {}
    for arch, (cfg, tokens) in parity.items():
        p32 = seeded_params(torch, cfg, dev0)
        with recorded_routes() as routes:
            want[arch] = (teacher_forced(torch, cfg, p32, tokens,
                                         p["prompt"], dev0,
                                         max_seq=p["max_seq"]),
                          [i.numpy() for _, i in routes])
        log(f"kv_seq parity: {arch} on {cfg.n_layers} layers, "
            f"{T.param_bytes(p32) / 1e9:.2f} GB of float32 in one process")
        del p32
    return dict(want=want, parity=parity, serve=serve, entry=entry), (
        parity, serve)


def kvseq_finish(args, torch, dev0, ctx, out):
    """Phases 45-46's checks of the ranks' results ``out``: 45,
    internvl2-1b on 12 layers and deepseek-v2-lite-16b on 2 in float32,
    the ranks' teacher-forced logits against one process's, bitwise equal
    on the ranks, routing equal; 46, internvl2-1b on 12 layers and
    deepseek-v2-lite-16b on 4 in bfloat16, greedy, tokens equal on the
    ranks, launches, a decode step's time and peak against the plan's,
    the plan's collectives against the ranks'.  Returns (each kernel's
    launches by path over the four ranks of phase 46, phase 44's record
    entry)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import card_mesh

    world = SHARDED_WORLD
    p, r = KVSEQ_PARITY, KVSEQ_RUN
    want, serve, entry = ctx["want"], ctx["serve"], ctx["entry"]

    # ------------- phase 45: float32 ranks against one process
    quarter = p["max_seq"] // world
    for arch, (logits, routes) in want.items():
        top = float(logits.abs().max())
        for rk, o in enumerate(out):
            g = o["parity"][arch]
            check(g["layout"] == ((rk * quarter, quarter), [quarter]),
                  f"kv_seq parity {arch}: rank {rk}'s cache {g['layout']}, "
                  f"expected a stretch of {quarter} at {rk * quarter}")
            lg = torch.from_numpy(g["logits"])
            check(bool(torch.isfinite(lg).all()) and lg.shape == logits.shape,
                  f"kv_seq parity {arch}: rank {rk}'s logits")
            torch.testing.assert_close(lg, logits, **SHARDED_TOL)
            check(np.array_equal(g["logits"],
                                 out[0]["parity"][arch]["logits"]),
                  f"kv_seq parity {arch}: rank {rk}'s logits differ from "
                  f"rank 0's")
            check(len(g["routes"]) == len(routes) and all(
                np.array_equal(a, b) for a, b in zip(g["routes"], routes)),
                f"kv_seq parity {arch}: rank {rk} routes tokens to other "
                f"experts")
            err = float((lg - logits).abs().max())
            log(f"kv_seq parity {arch} rank {rk}: stretch {g['layout'][0]} "
                f"of {p['max_seq']}; {g['weights_gb']:.2f} GB of float32 "
                f"weights; max |ranks - one process| {err:.3g} = "
                f"{err / top:.3g} of the largest logit {top:.3g} (rtol = "
                f"atol = 2e-4) over a prompt of {p['prompt']} and "
                f"{p['steps']} decode steps; {len(routes)} routings equal; "
                f"{g['s']:.1f} s")

    # ------------- phase 46: bfloat16 greedy on four ranks
    launches = {}
    quarter = r["max_seq"] // world
    for arch, (cfg, _) in serve.items():
        runs = [o["serve"][arch] for o in out]
        plans = {kind: D.plan(cfg, ShapeConfig(
                     f"kvseq_{kind}", seq, r["batch"], kind),
                     card_mesh("h100x4"))
                 for kind, seq in (("prefill", r["prompt"]),
                                   ("decode", r["max_seq"]))}
        plan_peak = plans["decode"]["sharded_step"]["predicted_peak_bytes"]
        lo, hi = KVSEQ_PEAK
        for rk, s in enumerate(runs):
            want_l = kvseq_launches(cfg, rk, r["prompt"], r["gen"],
                                    r["max_seq"])
            check(np.array_equal(s["tokens"], runs[0]["tokens"]),
                  f"kv_seq serve {arch}: rank {rk}'s tokens differ from "
                  f"rank 0's")
            check(s["layout"] == ((rk * quarter, quarter), [quarter]),
                  f"kv_seq serve {arch}: rank {rk}'s cache {s['layout']}")
            check(s["launches"] == want_l, f"kv_seq serve {arch}: rank {rk} "
                  f"launched {s['launches']}, expected {want_l}")
            for kind, rec in plans.items():
                check(rec["collectives"] == s["collectives"][kind],
                      f"kv_seq plan {arch} {kind}: {rec['collectives']} "
                      f"against rank {rk}'s {s['collectives'][kind]}")
            ratio = s["step_peak"] / plan_peak
            coll, step_t = s["collective_ms"]
            log(f"kv_seq serve {arch} rank {rk}: {s['weights_gb']:.2f} GB "
                f"of weights made in {s['build_s']:.1f} s beside "
                f"{s['held'] / 2**20:.0f} MiB held before; {r['batch']} x "
                f"{r['prompt']} prompt + {r['gen']} greedy tokens in "
                f"{s['served_s']:.3f} s (peak {s['peak'] / 1e9:.3f} GB); "
                f"decode step {s['step_ms']:.3f} ms (CUDA events), "
                f"{coll:.1f} of a timed step's {step_t:.1f} ms in gloo "
                f"collectives ({coll / step_t:.1%}, host clock, card "
                f"drained around each); the step's peak "
                f"{s['step_peak'] / 1e9:.4f} GB against the plan's rank-0 "
                f"{plan_peak / 1e9:.4f} GB ({ratio:.4f}, limits {lo}-{hi}); "
                f"launches {s['launches']}; {s['s']:.1f} s")
            check(lo <= ratio <= hi, f"kv_seq serve {arch}: rank {rk}'s "
                  f"step peak {s['step_peak'] / 1e9:.4f} GB against the "
                  f"plan's {plan_peak / 1e9:.4f} GB")
        toks = runs[0]["tokens"]
        check(toks.shape == (r["batch"], r["gen"]) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size,
              f"kv_seq serve {arch}: tokens of shape {toks.shape} out of "
              f"range")
        for kind, rec in plans.items():
            log(f"plan h100x4 {arch} {kind} (batch {r['batch']}, seq "
                f"{rec['seq_len']}, {cfg.n_layers} layers): collectives "
                f"equal to each rank's, {json.dumps(rec['collectives'])}; "
                f"rank 0's cache {rec['per_device_bytes']['cache'] / 1e9:.4f}"
                f" GB, predicted peak "
                f"{rec['sharded_step']['predicted_peak_bytes'] / 1e9:.4f} GB")
        launches[KVSEQ_PATHS[arch]] = {
            k: sum(s["launches"][k] for s in runs)
            for k in ("flash_attention", "flash_decode")}
    log(f"kv_seq launches by path (four ranks): {json.dumps(launches)}")
    return launches, entry


# ----- meshes with "data" above 1: the (2, 2) mesh (phases 47-49)
DATA_MESH = "h100x2x2"
DATA_PATHS = {"train": "llama3.2-1b train (2, 2)",
              "serve": "llama3.2-1b serve (2, 2)"}
# phase 47: deepseek-v2-lite-16b's first 2 layers (the dense one, an MoE
# one) at full width in float32: MLA split by heads (8 a rank), 32 of 64
# experts a rank, FSDP over "data"; 4 x 256 tokens (2 rows a "data"
# rank) in two microbatches, against one process
DATA_PARITY = dict(layers=2, batch=4, seq=256, accum=2)
# phase 48: llama3.2-1b in bfloat16, 3 steps of 4 x 2,048 tokens (2 rows
# a "data" rank) at TRAIN_OPT.  Alone (--phase data) all 16 layers: a
# rank holds a quarter of the 1.24 B parameters (0.62 GB) and of their
# float32 moments (2.47 GB), and one layer's gathered weights at a time;
# a step moves 6.8 GB through gloo, 14.4 s on one card (PERF.md, DP1).
# In the whole script its first 2 layers at full width, for the
# script's time (the embedding and tied head are most of a step's bytes)
DATA_TRAIN_RUN = dict(batch=4, seq=2048, steps=3)
DATA_TRAIN_LAYERS = 2
# phase 49: llama3.2-1b's 16 layers in bfloat16 served with the
# tensor-parallel resolver of decode: batch 4 (2 rows a "data" rank),
# prompt 256, 16 greedy tokens; float32 parity on its first 2 layers
DATA_SERVE_RUN = dict(batch=4, prompt=256, gen=16)
DATA_SERVE_PARITY = dict(layers=2, batch=4, prompt=64, steps=8)


def data_cfgs(train_layers=None):
    """Phases 47-49's configs: (deepseek's float32 cut, llama's bfloat16
    training config on ``train_layers``, whole unless given, llama's
    float32 cut, llama's serving config)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    ds = get_config("deepseek-v2-lite-16b")
    llama = get_config("llama3.2-1b")
    # phase 47 without remat: its recompute would gather the float32
    # layers over gloo again (phase 48 and the CPU tests run FSDP under
    # remat)
    return (replace(ds, dtype="float32", n_layers=DATA_PARITY["layers"],
                    accum_override=0, remat_policy="everything"),
            replace(llama, accum_override=0,
                    n_layers=train_layers or llama.n_layers),
            replace(llama, dtype="float32",
                    n_layers=DATA_SERVE_PARITY["layers"]),
            llama)


def data_prepare(args, torch, dev0):
    """Phases 47-49's set-up in the parent: the batches, the plan's
    (2, 2) rank-0 steps of phase 48's training cell and phase 49's
    serving cells, and phase 49's one-process float32 logits.  Returns
    (the context :func:`data_finish` reads, the ranks' arguments of
    :func:`data_rank`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.models import transformer as T

    mesh = card_mesh(DATA_MESH)
    ds32, train_cfg, serve32, serve_cfg = data_cfgs(
        None if args.phase == "data" else DATA_TRAIN_LAYERS)
    q = DATA_PARITY
    parity_batch = SyntheticPipeline(ds32, ShapeConfig(
        "data_parity", q["seq"], q["batch"], "train")).batch_at(0)
    B, S, steps = (DATA_TRAIN_RUN[k] for k in ("batch", "seq", "steps"))
    if args.small:
        S = 512
    shape = ShapeConfig("data_train", S, B, "train")
    pipe = SyntheticPipeline(train_cfg, shape,
                             DataConfig(seed=TRAIN["seed"]))
    batches = [pipe.batch_at(i) for i in range(steps)]
    held = pipe.batch_at(steps + 1)
    t0 = time.perf_counter()
    rec = D.plan(train_cfg, shape, mesh)
    own = rec["sharded_step"]
    check("refused" not in own, f"plan {DATA_MESH} train: "
          f"{own.get('refused')}")
    r = DATA_SERVE_RUN
    plans = {kind: D.plan(serve_cfg, ShapeConfig(
        f"data_{kind}", seq, r["batch"], kind), mesh)
        for kind, seq in (("prefill", r["prompt"]),
                          ("decode", r["prompt"] + r["gen"]))}
    log(f"plan {DATA_MESH}: the training and serving cells in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(49).integers(
        0, serve_cfg.vocab_size, (r["batch"], r["prompt"])).astype(np.int32)
    sp = DATA_SERVE_PARITY
    ptoks = np.random.default_rng(48).integers(
        0, serve32.vocab_size,
        (sp["batch"], sp["prompt"] + sp["steps"])).astype(np.int32)
    p32 = seeded_params(torch, serve32, dev0)
    want = teacher_forced(torch, serve32, p32, ptoks, sp["prompt"], dev0)
    log(f"data parity: {serve32.name} on {serve32.n_layers} layers, "
        f"{T.param_bytes(p32) / 1e9:.2f} GB of float32 in one process")
    del p32
    ctx = dict(train_cfg=train_cfg, serve_cfg=serve_cfg, B=B, S=S,
               steps=steps, rec=rec, own=own, plans=plans, want=want)
    return ctx, (ds32, parity_batch, train_cfg, batches, held, steps,
                 own["predicted_peak_bytes"], serve32, ptoks, serve_cfg,
                 prompts)


@contextlib.contextmanager
def captured_grads():
    """Record the gradients every ``adamw.apply_updates`` call takes while
    the block runs (a train step's, summed over its microbatches): a list
    of dicts by name, on their devices."""
    from repro_torch.optim import adamw

    seen, apply = [], adamw.apply_updates

    def capture(state, grads, *a, **kw):
        seen.append({n: g.detach() for n, g in grads.items()})
        return apply(state, grads, *a, **kw)

    adamw.apply_updates = capture
    try:
        yield seen
    finally:
        adamw.apply_updates = apply


def data_parity(torch, rank, dev, cfg, batch):
    """Phase 47 on one rank (the (2, 2) mesh, the FSDP resolver): one
    float32 ``make_train_step`` of two microbatches of ``batch`` from
    zero moments, its gradients captured; then, in turn, each rank runs
    the one-process step of the whole model (``res`` None) and holds its
    blocks of it against its own: the gradients within
    ``SHARDED_TRAIN_TOL`` of each largest |g|, the updated parameters as
    ``check_updates`` holds them, every routing of its rows.  Returns
    the losses, norms, errors and whether every routing was equal."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import card_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.parallel.collectives import sharded_run
    from repro_torch.training.step import make_train_step

    t0 = time.perf_counter()
    res = sharded_run(cfg, card_mesh(DATA_MESH), rank=rank,
                      group=dist.group.WORLD, train=True)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    accum = DATA_PARITY["accum"]
    rows = res.rows(DATA_PARITY["batch"] // accum)    # of a microbatch
    opt = OptConfig(**SHARDED_TRAIN_OPT)
    params = seeded_params(torch, cfg, dev, res)
    weights_gb = T.param_bytes(params) / 1e9
    fsdp = sum(hasattr(p, "fsdp") for p in params.parameters())
    times = {"build": time.perf_counter() - t0}
    t1 = time.perf_counter()
    with recorded_routes() as routes, captured_grads() as seen:
        state, met = make_train_step(cfg, opt, res=res, accum_steps=accum)(
            init_state(params, opt), b)
    times["step"] = time.perf_counter() - t1
    grads = {n: g.cpu() for n, g in seen[0].items()}
    updated = {n: p.detach().cpu() for n, p in params.named_parameters()}
    # the state holds the blocks and their moments: the turns below need
    # the card
    del params, seen, state
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            whole = seeded_params(torch, cfg, dev)
            with recorded_routes() as one_routes, \
                    captured_grads() as one_seen:
                one_state, one_met = make_train_step(
                    cfg, opt, accum_steps=accum)(init_state(whole, opt), b)
            one = one_seen[0]
            errs = {}
            for n, ref in rank_blocks(cfg, res, whole, one).items():
                top = float(torch.linalg.vector_norm(one[n], math.inf))
                errs[n] = float((grads[n].to(dev) - ref).abs().max()) / max(
                    top, 1e-30)
            del one, one_seen
            want = rank_blocks(cfg, res, whole, {
                n: p.detach() for n, p in whole.named_parameters()})
            step = check_updates(torch, {n: u.to(dev) for n, u in
                                         updated.items()},
                                 {n: w.cpu() for n, w in want.items()},
                                 opt.lr, f"data parity rank {rank}'s step")
            same = len(routes) == len(one_routes) and all(
                torch.equal(a[1], c[1][rows]) for a, c in
                zip(routes, one_routes))
            del whole, want, one_state
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    times["turns"] = time.perf_counter() - t1
    return dict(loss=float(met["loss"]), one_loss=float(one_met["loss"]),
                norm=float(met["grad_norm"]),
                one_norm=float(one_met["grad_norm"]), errs=errs, step=step,
                routes_equal=same, n_routes=len(routes),
                weights_gb=weights_gb, fsdp=fsdp, rows=(rows.start,
                                                        rows.stop),
                times=times, s=time.perf_counter() - t0)


def data_rank(rank, world, ds32, parity_batch, train_cfg, batches, held,
              steps, plan_peak, serve32, ptoks, serve_cfg, prompts):
    """Phases 47-49 on one rank of the (2, 2) mesh: :func:`data_parity`;
    :func:`train_run` of llama3.2-1b under the FSDP resolver; its float32
    cut's teacher-forced logits of the rank's rows and
    :func:`kvseq_serve` of the whole model under the decode resolver."""
    import gc

    import torch.distributed as dist

    from repro_torch.launch.mesh import card_mesh
    from repro_torch.parallel.collectives import sharded_run

    torch, _, dev = rank_setup(rank, world, ds32, train=True)
    mesh = card_mesh(DATA_MESH)
    out = {"parity": data_parity(torch, rank, dev, ds32, parity_batch)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sharded_run(train_cfg, mesh, rank=rank, group=dist.group.WORLD,
                      train=True)
    out["train"] = train_run(torch, res, dev, train_cfg, batches, held,
                             steps, plan_peak)
    out["train"]["s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sharded_run(serve32, mesh, rank=rank, group=dist.group.WORLD)
    params = seeded_params(torch, serve32, dev, res)
    B = len(ptoks)
    rows = res.rows(B)
    out["serve_parity"] = dict(
        rows=(rows.start, rows.stop),
        logits=teacher_forced(torch, serve32, params, ptoks[rows],
                              DATA_SERVE_PARITY["prompt"], dev, res,
                              batch=B).numpy())
    del params
    torch.cuda.empty_cache()
    r = DATA_SERVE_RUN
    res = sharded_run(serve_cfg, mesh, rank=rank, group=dist.group.WORLD)
    out["serve"] = kvseq_serve(torch, res, dev, serve_cfg, prompts,
                               r["prompt"] + r["gen"], r["gen"])
    sl = res.rows(len(prompts))
    out["serve"]["rows"] = (sl.start, sl.stop)
    out["serve"]["s"] = time.perf_counter() - t0
    return out


def data_finish(args, torch, dev0, ctx, out):
    """Phases 47-49's checks of the ranks' results ``out``: 47, the
    float32 loss, gradients, norm and AdamW update of one step of two
    microbatches of deepseek's 2 layers against one process, routing
    equal, the loss and norm bitwise equal on the four ranks; 48,
    llama3.2-1b trained: launches, step time, busy share, time in gloo
    by kind, each rank's peak against the plan's (2, 2) rank-0 peak, the
    plan's collectives against each rank's, the held-out objective
    falling; 49, llama3.2-1b served: the float32 rows against one
    process's, tokens bitwise equal within each "data" pair, launches,
    the plan's collectives against each rank's.  Then
    ``flash_attention`` and ``flash_attention_bwd`` at a rank's training
    shapes and ``flash_decode`` at its serving shape against their plain
    versions.  Returns (each kernel's launches by path over the four
    ranks, its record entry at those shapes)."""
    tol = SHARDED_TRAIN_TOL
    # ----------- phase 47: float32 training parity on (2, 2)
    stamp("phase 47")
    got = [o["parity"] for o in out]
    for rk, g in enumerate(got):
        rel = abs(g["loss"] - g["one_loss"]) / abs(g["one_loss"])
        worst = max(g["errs"].items(), key=lambda kv: kv[1])
        nrel = abs(g["norm"] - g["one_norm"]) / g["one_norm"]
        log(f"data parity rank {rk} (float32, TF32 off, {DATA_PARITY['batch']}"
            f" x {DATA_PARITY['seq']} in {DATA_PARITY['accum']} microbatches,"
            f" rows {g['rows']} of each): {g['weights_gb']:.2f} GB of "
            f"weights, {g['fsdp']} blocks split over 'data'; the step's loss "
            f"{g['loss']:.7f} against one process's {g['one_loss']:.7f} "
            f"({rel:.3g}); every gradient made whole within {worst[1]:.3g} "
            f"of its largest |g| ({worst[0]}); norm {g['norm']:.6f} against "
            f"{g['one_norm']:.6f} ({nrel:.3g}); the updates worst "
            f"{g['step'][0]:.3g} of their tolerance, {g['step'][1]} of "
            f"{g['step'][2]} elements outside 1e-3; {g['n_routes']} "
            f"routings equal: {g['routes_equal']}; {g['s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f} s" for k, v in g["times"].items())
            + ")")
        check(math.isfinite(g["loss"]) and rel <= tol["loss"],
              f"data parity: rank {rk}'s loss {g['loss']} against "
              f"{g['one_loss']}")
        check(worst[1] <= tol["grad"], f"data parity: rank {rk}'s "
              f"{worst[0]} gradient {worst[1]:.3g} of its largest away")
        check(nrel <= tol["norm"], f"data parity: rank {rk}'s norm "
              f"{g['norm']} against {g['one_norm']}")
        check(g["routes_equal"] and g["n_routes"] > 0,
              f"data parity: rank {rk} routes tokens to other experts")
        check(g["fsdp"] > 0, f"data parity: rank {rk} holds no FSDP block")
        check((g["loss"], g["norm"]) == (got[0]["loss"], got[0]["norm"]),
              f"data parity: rank {rk}'s loss or norm differs from rank "
              f"0's")

    # ----------- phase 48: llama3.2-1b trained on (2, 2) in bfloat16
    stamp("phase 48")
    cfg, B, S, steps, rec, own = (ctx[k] for k in (
        "train_cfg", "B", "S", "steps", "rec", "own"))
    runs = [o["train"] for o in out]
    want_l = {k: v * steps for k, v in per_packet(cfg).items()}
    lo, hi = SHARDED_TRAIN_PEAK
    for rk, t in enumerate(runs):
        ratio = t["peak"] / t["plan_peak"]
        step_ms = t["step_ms"]
        kinds = {k: round(v, 1) for k, v in t["collective_kinds_ms"].items()}
        log(f"data train rank {rk}: {t['weights_gb']:.3f} GB of weights made "
            f"with their moments in {t['build_s']:.1f} s; losses "
            f"{[round(x, 4) for x in t['losses']]}; step s "
            f"{[round(x, 3) for x in t['step_s']]} (the plain step "
            f"{step_ms:.1f} ms, {B * S / step_ms * 1e3:.0f} tokens/s "
            f"a rank set); kernel ms a step {t['kernel_ms']:.1f}, busy "
            f"{t['kernel_ms'] / step_ms:.1%}; in collectives "
            f"{t['collective_ms'][0]:.1f} ms of the timed step's "
            f"{t['collective_ms'][1]:.1f} ms, by kind {kinds} (host clock, "
            f"card drained around each); peak {t['peak'] / 1e9:.3f} GB "
            f"against the plan's rank-0 {t['plan_peak'] / 1e9:.3f} GB "
            f"({ratio:.4f}, limits {lo}-{hi}); held-out objective "
            f"{t['before']:.6f} -> {t['after']:.6f}; launches "
            f"{t['launches']}; collectives a step "
            f"{json.dumps(t['collectives'])}; {t['s']:.1f} s")
        check(t["launches"] == want_l, f"data train: rank {rk} launched "
              f"{t['launches']}, expected {want_l}")
        check(all(math.isfinite(x) for x in t["losses"])
              and t["after"] < t["before"],
              f"data train: rank {rk}'s losses {t['losses']}, held-out "
              f"objective {t['before']} -> {t['after']}")
        check(t["losses"] == runs[0]["losses"], f"data train: rank {rk}'s "
              f"losses differ from rank 0's")
        check(lo <= ratio <= hi, f"data train: rank {rk}'s peak "
              f"{t['peak'] / 1e9:.3f} GB against the plan's "
              f"{t['plan_peak'] / 1e9:.3f} GB ({ratio:.4f})")
        check(t["collectives"] == rec["collectives"],
              f"data train: rank {rk} counted {t['collectives']}, the plan "
              f"{rec['collectives']}")
    log(f"plan {DATA_MESH} train (batch {B}, seq {S}, {cfg.n_layers} "
        f"layers): collectives equal to each rank's counted step, "
        f"{json.dumps(rec['collectives'])}; rank 0's arguments "
        f"{rec['argument_bytes_per_device'] / 1e9:.3f} GB, its predicted "
        f"peak {own['predicted_peak_bytes'] / 1e9:.3f} GB (even share "
        f"{rec['predicted_peak_bytes_per_device'] / 1e9:.3f} GB)")

    # ----------- phase 49: llama3.2-1b served on (2, 2)
    stamp("phase 49")
    want = ctx["want"]
    top = float(want.abs().max())
    for rk, o in enumerate(out):
        g = o["serve_parity"]
        rows = slice(*g["rows"])
        lg = torch.from_numpy(g["logits"])
        check(bool(torch.isfinite(lg).all())
              and lg.shape == want[rows].shape,
              f"data serve parity: rank {rk}'s logits {tuple(lg.shape)}")
        torch.testing.assert_close(lg, want[rows], **SHARDED_TOL)
        err = float((lg - want[rows]).abs().max())
        log(f"data serve parity rank {rk}: rows {g['rows']}; max |rank - "
            f"one process| {err:.3g} = {err / top:.3g} of the largest logit "
            f"(rtol = atol = 2e-4)")
    scfg, r, plans = ctx["serve_cfg"], DATA_SERVE_RUN, ctx["plans"]
    serves = [o["serve"] for o in out]
    want_s = {"flash_attention": scfg.n_layers, "selective_scan": 0,
              "selective_scan_fused": 0,
              "flash_decode": scfg.n_layers * (r["gen"] - 1)}
    plan_peak = plans["decode"]["sharded_step"]["predicted_peak_bytes"]
    for rk, sv in enumerate(serves):
        pair = serves[rk - rk % 2]      # the rank of model coordinate 0
        check(sv["rows"] == pair["rows"] and np.array_equal(
            sv["tokens"], pair["tokens"]), f"data serve: rank {rk}'s tokens "
            f"differ from its 'data' pair's")
        check(sv["launches"] == want_s, f"data serve: rank {rk} launched "
              f"{sv['launches']}, expected {want_s}")
        for kind, prec in plans.items():
            check(prec["collectives"] == sv["collectives"][kind],
                  f"data plan {kind}: {prec['collectives']} against rank "
                  f"{rk}'s {sv['collectives'][kind]}")
        coll, step_t = sv["collective_ms"]
        log(f"data serve rank {rk}: rows {sv['rows']}, {sv['weights_gb']:.3f}"
            f" GB of weights made in {sv['build_s']:.1f} s beside "
            f"{sv['held'] / 2**20:.0f} MiB held before; "
            f"{r['batch']} x {r['prompt']} prompt + {r['gen']} greedy "
            f"tokens in {sv['served_s']:.3f} s (peak {sv['peak'] / 1e9:.3f} "
            f"GB); decode step {sv['step_ms']:.3f} ms (CUDA events), "
            f"{coll:.1f} of a timed step's {step_t:.1f} ms in gloo "
            f"collectives; the step's peak {sv['step_peak'] / 1e9:.4f} GB "
            f"against the plan's rank-0 {plan_peak / 1e9:.4f} GB; launches "
            f"{sv['launches']}; {sv['s']:.1f} s")
    toks = np.concatenate([serves[0]["tokens"], serves[2]["tokens"]])
    check(toks.shape == (r["batch"], r["gen"]) and int(toks.min()) >= 0
          and int(toks.max()) < scfg.vocab_size,
          f"data serve: tokens of shape {toks.shape} out of range")
    for kind, prec in plans.items():
        log(f"plan {DATA_MESH} serve {kind} (batch {r['batch']}, seq "
            f"{prec['seq_len']}): collectives equal to each rank's, "
            f"{json.dumps(prec['collectives'])}; rank 0's predicted peak "
            f"{prec['sharded_step']['predicted_peak_bytes'] / 1e9:.4f} GB")

    H, KH = cfg.n_heads // 2, cfg.n_kv_heads // 2
    D_, bf16 = cfg.resolved_head_dim, torch.bfloat16
    Bl = B // 2
    gen_t = torch.Generator(dev0).manual_seed(47)

    def randn(shape_, dtype):
        return torch.randn(shape_, generator=gen_t, device=dev0).to(dtype)

    log("kernels at a (2, 2) rank's shapes against their plain versions:")
    shapes = {
        "flash_attention": attn_check(torch, randn, Bl, S, H, KH, D_, bf16,
                                      timed=True),
        "flash_attention_bwd": attn_bwd_check(torch, randn, Bl, S, H, KH,
                                              D_, bf16, timed=True),
        "flash_decode": decode_check(
            torch, randn, r["batch"] // 2, r["prompt"] + r["gen"], H, KH,
            D_, r["prompt"] + r["gen"] - 1, bf16, timed=True)}
    entries = {k: long_entry(v, f"{k}, a (2, 2) rank's share")
               for k, v in shapes.items()}
    launches = {
        DATA_PATHS["train"]: {k: sum(t["launches"][k] for t in runs)
                              for k in ("flash_attention",
                                        "flash_attention_bwd")},
        DATA_PATHS["serve"]: {k: sum(sv["launches"][k] for sv in serves)
                              for k in ("flash_attention", "flash_decode")}}
    log(f"(2, 2) launches by path (four ranks): {json.dumps(launches)}")
    return launches, entries


def late_rank(rank, world, train, kvseq, data):
    """Phases 42-43, 45-46 and 47-49 on one rank, one spawn for all (a
    phase group whose arguments are None is left out)."""
    import gc

    import torch
    out, held = {}, {}
    for key, fn, a in (("train", sharded_train_rank, train),
                       ("kvseq", kvseq_rank, kvseq),
                       ("data", data_rank, data)):
        if a is not None:
            out[key] = fn(rank, world, *a)
            gc.collect()
            torch.cuda.empty_cache()
            held[key] = torch.cuda.memory_allocated()
    out["held"] = held
    return out


def late_sharded_phases(args, torch, dev0, which=("train", "kvseq",
                                                  "data")):
    """Phases 42-49, those of ``which``: each group's set-up in the
    parent (``*_prepare``), one spawn of four gloo ranks for them all
    (:func:`late_rank`), then each group's checks (``*_finish``).
    Returns by group what its ``*_finish`` returns."""
    ctx, jobs = {}, {}
    if "train" in which:
        stamp("phases 42-43: set-up")
        ctx["train"], jobs["train"] = sharded_train_prepare(args, torch,
                                                            dev0)
    if "kvseq" in which:
        ctx["kvseq"], jobs["kvseq"] = kvseq_prepare(args, torch, dev0)
    if "data" in which:
        stamp("phases 47-49: set-up")
        ctx["data"], jobs["data"] = data_prepare(args, torch, dev0)
    stamp("phases " + ", ".join({"train": "42-43", "kvseq": "45-46",
                                 "data": "47-49"}[k] for k in which)
          + " on four ranks")
    t0 = time.perf_counter()
    out = run_ranks(torch, dev0, late_rank, jobs.get("train"),
                    jobs.get("kvseq"), jobs.get("data"))
    log(f"late sharded ranks: {time.perf_counter() - t0:.1f} s with the "
        f"spawn; bytes each rank holds after each group: "
        f"{[o['held'] for o in out]}")
    finish = {"train": sharded_train_finish, "kvseq": kvseq_finish,
              "data": data_finish}
    results = {}
    for k in which:
        if k == "train":
            stamp("phases 42-43")
        elif k == "kvseq":
            stamp("phases 45-46")
        results[k] = finish[k](args, torch, dev0, ctx[k],
                               [o[k] for o in out])
    return results


def device_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small sizes instead of the paper's")
    ap.add_argument("--phase", choices=["fleet", "plan", "served",
                                        "sharded", "trained",
                                        "sharded_train", "kvseq", "data"],
                    help="build, then run these phases alone (fleet: 8a; "
                         "plan: 26-30; served: 31-34; sharded: 35-37; "
                         "trained: 38-41; sharded_train: 42-43; kvseq: "
                         "44-46; data: 47-49) as a quicker check; prints "
                         "no kernels line")
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

    if args.phase == "served":
        served, _, _ = served_configs_phases(args, torch, dev0)
        log(f"served launches: {json.dumps(served)}")
        print(smi)
        print(device_line(torch))
        return 0

    if args.phase == "sharded":
        sharded, _ = sharded_phases(args, torch, dev0)
        log(f"sharded launches: {json.dumps(sharded)}")
        print(smi)
        print(device_line(torch))
        return 0

    late = {"sharded_train": "train", "kvseq": "kvseq", "data": "data"}
    if args.phase in late:
        key = late[args.phase]
        got, _ = late_sharded_phases(args, torch, dev0, (key,))[key]
        log(f"{args.phase} launches: {json.dumps(got)}")
        print(smi)
        print(device_line(torch))
        return 0

    if args.phase == "trained":
        runs, _, _ = dense_train_phases(args, torch, dev0)
        log("trained launches: " + json.dumps(
            {m: r["launches"] for m, r in runs.items()}))
        print(smi)
        print(device_line(torch))
        return 0

    if args.phase == "plan":
        plan_phase(args)
        checks = {"llama3.2-1b": llama_plan_phase(args, torch, dev0)}
        mla_bwd_phase(args, torch, dev0)
        run, checks["deepseek-v2-lite-16b"] = deepseek_train_phases(
            args, torch, dev0)
        log(f"deepseek training launches: {json.dumps(run['launches'])}")
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
    stamp("phases 3-5")
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

    stamp("phases 5a-5e")
    suite_phases(args, torch, dev0, attach, host_runs)
    stamp("phase 5f")
    host_info = host_phase(args, torch, dev0, attach, host_runs,
                           host_build_s)
    # phase 26's planning runs beside the card phases from here on (not
    # beside phase 5f, which times the host routines on the host's cores)
    planning = start_plan(PLAN_BACKGROUND_WORKERS)
    stamp("phases 6-8")
    serving_phases(args, torch, dev0, launches, record)
    paths = {}
    stamp("phase 8a")
    fleet_phase(args, torch, dev0, paths)
    stamp("phases 9-11")
    op_path = mamba_phases(args, torch, dev0, launches, record)
    stamp("phases 12-13")
    training_phases(args, torch, dev0, launches, attach)
    stamp("phase 14")
    attention_bwd_phase(args, torch, dev0, record)
    stamp("phases 15-17")
    mla_phases(args, torch, dev0, record)
    stamp("phases 18-19")
    paths["jamba-v0.1-52b"], jamba_a, jamba_d = jamba_phases(args, torch,
                                                             dev0)
    stamp("phase 20")
    paths["internvl2-1b"], g7_a, g7_d = vlm_phase(args, torch, dev0)
    stamp("phase 21")
    paths["musicgen-large"], mg_a, mg_d = audio_phase(args, torch, dev0)
    # phases 8a and 18-21 add their paths' launches to the three kernels'
    # records
    for rec in records:
        if rec["name"] not in SERVED_KERNELS:
            continue
        by = rec.get("launches_by_path") or {
            SERVED_KERNELS[rec["name"]]: rec["launches"]}
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
    stamp("phase 22")
    scan_bwd, fused_bwd = scan_bwd_phase(args, torch, dev0)
    trained = {}
    stamp("phases 23-24")
    trained["jamba-v0.1-52b"], jamba_b = jamba_train_phases(args, torch,
                                                            dev0)
    trained["falcon-mamba-7b"] = falcon_train_phase(args, torch, dev0)
    stamp("phase 25")
    front, front_b = frontend_train_phase(args, torch, dev0)
    trained.update(front)

    # phases 26-30: the planner, then MLA's backward and deepseek trained
    stamp("phases 26-27")
    plan_phase(args, planning)
    plan_checks = {"llama3.2-1b": llama_plan_phase(args, torch, dev0)}
    stamp("phase 28")
    mla_b = mla_bwd_phase(args, torch, dev0)
    stamp("phases 29-30")
    ds_run, plan_checks["deepseek-v2-lite-16b"] = deepseek_train_phases(
        args, torch, dev0)
    trained["deepseek-v2-lite-16b"] = ds_run
    by_path = {k: {f"{m} training": t["launches"][k]
                   for m, t in trained.items() if t["launches"][k]}
               for k in train_kernels()}
    for name, m in (("selective_scan_bwd", scan_bwd),
                    ("selective_scan_fused_bwd", fused_bwd)):
        record(name, "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/mamba_scan/kernel.py:55", m["err"],
               m["ms"], m["plain_ms"], m["nbytes"], m["ops"], None,
               m["shape"] + " (training packet)",
               n_launches=sum(by_path[name].values())
               + op_path.get(name, 0),
               launches_by_path=dict(by_path[name], **(
                   {OP_PATH: op_path[name]} if name in op_path else {})),
               replaces_note="the gradient of that kernel's function: the "
                             "JAX package differentiates its jnp scan "
                             "(src/repro/models/layers.py:559 "
                             "_ssm_scan_chunked"
                             + (", and its discretisation :608-611"
                                if "fused" in name else "")
                             + ") with jax.value_and_grad",
               library_note="no single PyTorch call computes this "
                            "recurrence or its gradient")
    # the training paths' launches join the other kernels' records
    for rec in records:
        extra = by_path.get(rec["name"])
        if not extra or rec["name"] in ("selective_scan_bwd",
                                        "selective_scan_fused_bwd"):
            continue
        by = rec.get("launches_by_path") or {
            ("llama3.2-1b training" if rec["name"] == "flash_attention_bwd"
             else SERVED_KERNELS[rec["name"]]): rec["launches"]}
        by.update(extra)
        rec.update(launches=sum(by.values()), launches_by_path=by)
    ds_path = "deepseek-v2-lite-16b training"
    ds_l = ds_run["launches"]
    record("flash_attention_bwd_d192",
           "src/repro_torch/csrc/flash_attention_bwd.cu",
           "src/repro/kernels/flash_attention/kernel.py:69", mla_b["err"],
           mla_b["ms"], mla_b["plain_ms"], mla_b["nbytes"], mla_b["ops"],
           mla_b["library_ms"], mla_b["shape"] + " (MLA's training packet "
           "of one row)", mla_b["ops_per_s"],
           n_launches=ds_l["flash_attention_bwd"],
           launches_by_path={ds_path: ds_l["flash_attention_bwd"]},
           kernels_ms=mla_b["kernels_ms"],
           v_width_ms=mla_b["v_width_ms"], v_padded_ms=mla_b["v_padded_ms"],
           replaces_note="the gradient of that kernel's function at MLA's "
                         "head dim: the JAX package differentiates its jnp "
                         "attention (src/repro/models/layers.py:315-335) "
                         "with jax.value_and_grad",
           library_note="torch.autograd.grad through one "
                        "F.scaled_dot_product_attention(is_causal=True), "
                        "the backward alone")
    d192 = next(r for r in records if r["name"] == "flash_attention_d192")
    by = d192.get("launches_by_path") or {
        "deepseek-v2-lite-16b serving": d192["launches"]}
    by[ds_path] = ds_l["flash_attention"]
    d192.update(launches=sum(by.values()), launches_by_path=by)
    attach("flash_attention_bwd",
           jamba_shape=long_entry(jamba_b, "jamba-v0.1-52b's heads"),
           g7_shape=long_entry(front_b["internvl2-1b"],
                               "G = 7 (internvl2-1b)"),
           musicgen_shape=long_entry(front_b["musicgen-large"],
                                     "musicgen-large's heads"))
    # phases 31-34: qwen3-32b, yi-9b, stablelm-3b and dbrx-132b served;
    # their launches join the two served kernels' records
    served, entries, _ = served_configs_phases(args, torch, dev0)
    for rec in records:
        if rec["name"] in entries:
            by = rec["launches_by_path"]
            by.update((m, c[rec["name"]]) for m, c in served.items()
                      if c.get(rec["name"]))
            rec.update(launches=sum(by.values()), **entries[rec["name"]])
    # phases 35-37: jamba-v0.1-52b served by four ranks on the card; the
    # ranks' launches join the three kernels' records
    stamp("phases 35-37")
    sharded, shapes = sharded_phases(args, torch, dev0)
    for rec in records:
        if rec["name"] in sharded:
            by = rec["launches_by_path"]
            by[SHARDED_PATH] = sharded[rec["name"]]
            rec.update(launches=sum(by.values()),
                       sharded_shape=shapes[rec["name"]])
    # phases 38-41: qwen3-32b, yi-9b, stablelm-3b and dbrx-132b trained;
    # their launches join the two attention kernels' records
    dense, dense_checks, dense_b = dense_train_phases(args, torch, dev0)
    trained.update(dense)
    plan_checks.update(dense_checks)
    for rec in records:
        if rec["name"] in ("flash_attention", "flash_attention_bwd"):
            by = rec["launches_by_path"]
            by.update((f"{m} training", t["launches"][rec["name"]])
                      for m, t in dense.items())
            rec.update(launches=sum(by.values()))
    attach("flash_attention_bwd", **{
        f"{m.split('-')[0]}_train_shape": e for m, e in dense_b.items()})
    # phases 42-49 on one spawn of four ranks: jamba-v0.1-52b trained by
    # four ranks (42-43), internvl2-1b and deepseek-v2-lite-16b served
    # over caches split by positions (44-46), and the (2, 2) mesh (47-49)
    late = late_sharded_phases(args, torch, dev0)
    # phases 42-43's launches join the four training kernels' records
    sharded_t, shapes_t = late["train"]
    for rec in records:
        if rec["name"] in sharded_t:
            by = rec["launches_by_path"]
            by[SHARDED_TRAIN_PATH] = sharded_t[rec["name"]]
            rec.update(launches=sum(by.values()),
                       sharded_train_shape=shapes_t[rec["name"]])
    # phases 45-46's launches join the two attention kernels' records
    kvseq, kvseq_entry = late["kvseq"]
    for rec in records:
        if rec["name"] in ("flash_attention", "flash_decode"):
            by = rec["launches_by_path"]
            by.update((path, c[rec["name"]]) for path, c in kvseq.items()
                      if c[rec["name"]])
            rec.update(launches=sum(by.values()))
    attach("flash_decode", kvseq_shape=kvseq_entry)
    # phases 47-49's launches and shapes join the three kernels' records
    data, data_entries = late["data"]
    for rec in records:
        if rec["name"] in data_entries:
            by = rec["launches_by_path"]
            by.update((path, c[rec["name"]]) for path, c in data.items()
                      if c.get(rec["name"]))
            rec.update(launches=sum(by.values()),
                       data_shape=data_entries[rec["name"]])
    log("training table: " + json.dumps(
        {m: {k: t[k] for k in ("step_s", "tokens_s", "busy", "peak_gb")}
         for m, t in trained.items()}))
    log("plan against the card: " + json.dumps(
        {m: {k: c[k] for k in ("args_bytes", "args_allocated", "peak",
                               "planned_peak", "peak_ratio", "flop_share")}
         for m, c in plan_checks.items()}))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    check(not leaked, f"the port imported {leaked}")

    stamp("done")
    print(json.dumps({"kernels": records, "host": host_info}))
    print(smi)
    print(device_line(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
