"""Dispatch engine: EngineCL's Runtime / Scheduler / Device threads in
PyTorch.

Mirrors the paper's Fig. 2 architecture:

  * the **Runtime** (the session's dispatcher, repro_torch.api.session)
    discovers executors, owns buffers/executable caches and orchestrates
    runs;
  * the **Scheduler** is the atomic packet queue (core/scheduler.py);
  * one **Device thread** per device group pulls packets, executes the
    program's range function and commits results.

This module is the *internal* layer of that stack: ``Program`` (the work
description), ``WorkerPool`` (session-scoped reusable device threads) and
``_RunContext`` (the per-submitted-program dispatch state).  The public
surface is the tiered API in ``repro_torch.api``:

  * Tier-1 ``coexec(program, devices=...)`` — one call, paper-tuned
    defaults;
  * Tier-2 ``EngineSession`` — executable cache + buffer registry + elastic
    membership shared across *many* programs, ``submit() -> RunHandle``;
  * Tier-3 ``register_scheduler`` / ``DevicePolicy`` / ``BufferPolicy``
    extension points.

The paper's two runtime optimizations remain real, independent code paths:

  * parallel init (the old ``opt_init``) — device threads build their
    executables (input staging onto the device) *in parallel*, overlapped
    with the Runtime's scheduler preparation; built executables are
    cached on the session and reused across submits (the paper's "reuse
    of costly OpenCL primitives").
  * registered buffers (the old ``opt_buffers``, now
    ``BufferPolicy.REGISTERED``) — inputs are registered once per device
    (zero-copy slice views feed each packet), outputs are committed in
    place.  ``BufferPolicy.PER_PACKET`` reproduces the worst practice the
    paper's drivers exhibited: every packet copies, results are assembled
    from per-packet copies at the end.

Timing modes per the paper: ``binary`` (init -> teardown) and ``roi``
(transfer + compute only) — both are measured per run as a
:class:`repro_torch.core.metrics.PhaseBreakdown` stamped by the run's
:class:`PhaseClock` (one timing implementation for all phases).

Work geometry: a Program's work is a :class:`repro_torch.core.region.Region`
(1-D or 2-D NDRange).  1-D range kernels keep the classic
``fn(offset, size)`` contract; 2-D programs build
``fn(row0, n_rows, col0, n_cols)`` tile kernels, and schedulers carve
their regions as row panels.  A run may cover a *sub-region* of the
program (the paper's ROI offloading) — the session validates containment
and per-dimension lws alignment before dispatch.

Fault tolerance: a device thread that raises (or whose DeviceGroup is
marked dead) has its in-flight packet requeued with provenance preserved
(same ``seq``, ``retried=True``); remaining devices absorb the work.

Dispatch modes: ``dispatch="leased"`` (default) pulls packets through the
scheduler's lease API — one global lock crossing buys a whole per-device
packet plan, and device threads pop their local lease uncontended.
``dispatch="per_packet"`` is the classic one-lock-per-packet hand-off,
kept as the measurable baseline (``benchmarks/sched_overhead.py``).
Either way the run stamps ``RunResult.sched_wait_s`` — per-device wall
time blocked on the scheduler hand-off (lock waits, carves, steals).
The exactly-once drain test is the scheduler's own ``drained()``
protocol (acquire/release claims + a retry-epoch check), so the engine
no longer serializes every pull through a run-global lock.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device import DeviceFailure, DeviceGroup
from repro_torch.core.membuf import BufferArena, BufferPolicy, TransferPipeline
from repro_torch.core.metrics import PhaseBreakdown, RunResult
from repro_torch.core.region import Region
from repro_torch.core.scheduler import (DeviceProfile, SchedulerBase,
                                        make_scheduler)
from repro_torch.energy.meter import EnergyMeter


class PhaseClock:
    """Named wall-clock marks for one run's phase accounting.

    The runtime's single timing implementation: every phase boundary is a
    ``mark``; durations are read back with ``between``/``since``.  Unset
    marks read as 0.0 so partial runs (e.g. scheduler construction
    failures) never crash the accounting path.
    """

    def __init__(self):
        self._t: Dict[str, float] = {}
        self._once = threading.Lock()

    def mark(self, name: str) -> float:
        t = time.perf_counter()
        self._t[name] = t
        return t

    def mark_once(self, name: str) -> float:
        """Set ``name`` only if unset (first caller wins; thread-safe) —
        e.g. the ROI mark stamped by whichever device computes first."""
        with self._once:
            t = self._t.get(name)
            if t is None:
                t = self.mark(name)
            return t

    def at(self, name: str) -> Optional[float]:
        return self._t.get(name)

    def since(self, name: str) -> float:
        t = self._t.get(name)
        return 0.0 if t is None else time.perf_counter() - t

    def between(self, a: str, b: str) -> float:
        ta, tb = self._t.get(a), self._t.get(b)
        if ta is None or tb is None:
            return 0.0
        return max(0.0, tb - ta)


@dataclass
class Program:
    """A single massively data-parallel task (the paper's redefined
    'program'): inputs, an output pattern, and a range kernel over a
    1-D or 2-D work Region."""
    name: str
    total_work: int = 0                   # dim-0 work-groups (mirrors region)
    lws: int = 1                          # dim-0 alignment unit (mirrors)
    # build(device_group) -> range executable:
    #   1-D: fn(offset, size)                   -> torch.Tensor
    #   2-D: fn(row0, n_rows, col0, n_cols)     -> torch.Tensor tile
    build: Optional[Callable[[DeviceGroup], Callable[..., Any]]] = None
    # output row-width: result rows per dim-0 work-group (paper's "out
    # pattern"); for 2-D programs out_cols is per dim-1 work-item
    out_rows_per_wg: int = 1
    out_cols: int = 1
    out_dtype: Any = np.float32
    region: Optional[Region] = None       # full NDRange (None = legacy 1-D)
    # read-only input footprint (bytes).  Registered/pooled buffers stage
    # it once per device; BufferPolicy.PER_PACKET re-stages it on every
    # packet (a real host copy of this size — the paper's "unnecessary
    # complete bulk copies of memory regions", the sim's BULK_COPY term).
    in_bytes: int = 0

    def __post_init__(self):
        if self.region is not None:
            # keep the legacy flat fields in lockstep with dim 0 so every
            # total_work/lws consumer sees the carved axis
            self.total_work = self.region.dims[0].size
            self.lws = self.region.dims[0].lws

    @property
    def work_region(self) -> Region:
        """The program's full NDRange (legacy programs: 1-D at offset 0)."""
        if self.region is not None:
            return self.region
        return Region.line(self.total_work, lws=self.lws)

    @property
    def ndim(self) -> int:
        return 1 if self.region is None else self.region.ndim

    def validate(self) -> "Program":
        """Raise a clear ValueError now instead of a TypeError deep inside a
        device thread.  Called at session submit / workload registration."""
        if self.build is None or not callable(self.build):
            raise ValueError(
                f"Program {self.name!r}: 'build' must be a callable "
                "build(device) -> fn(offset, size); got "
                f"{self.build!r}.  Construct Programs via "
                "repro_torch.core.programs or pass build= explicitly.")
        if self.total_work <= 0:
            raise ValueError(f"Program {self.name!r}: total_work must be "
                             f"positive, got {self.total_work}")
        if self.lws <= 0:
            raise ValueError(f"Program {self.name!r}: lws must be positive, "
                             f"got {self.lws}")
        return self


class WorkerPool:
    """Session-scoped pool of reusable device threads.

    Device threads are *pulled from the pool* per run instead of created per
    run: a session serving many back-to-back submits reuses the same OS
    threads (the thread-management analogue of the paper's primitive reuse).

    Deliberately NOT concurrent.futures.ThreadPoolExecutor: every run parks
    all n device threads on one Barrier, so the pool must grow unboundedly
    with the fleet — a bounded executor whose max_workers falls below the
    device count would deadlock the barrier.
    """

    def __init__(self, name: str = "coexec"):
        self._name = name
        self._lock = threading.Lock()
        self._idle: List["_Worker"] = []
        self._spawned = 0
        self._closed = False

    def submit(self, fn: Callable[[], None]) -> threading.Event:
        """Run ``fn`` on a pooled thread; returns its completion event."""
        with self._lock:
            if self._closed:
                raise RuntimeError("WorkerPool is closed")
            worker = self._idle.pop() if self._idle else None
            if worker is None:
                self._spawned += 1
                worker = _Worker(self, f"{self._name}-dev-{self._spawned}")
        return worker.run(fn)

    def _recycle(self, worker: "_Worker") -> None:
        with self._lock:
            if self._closed:
                worker.stop()
            else:
                self._idle.append(worker)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for w in idle:
            w.stop()

    @property
    def size(self) -> int:
        return self._spawned


class _Worker:
    """One reusable pool thread: blocks on a job box, runs, recycles."""

    def __init__(self, pool: WorkerPool, name: str):
        self._pool = pool
        self._job: Optional[Tuple[Callable[[], None], threading.Event]] = None
        self._wake = threading.Semaphore(0)
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def run(self, fn: Callable[[], None]) -> threading.Event:
        done = threading.Event()
        self._job = (fn, done)
        self._wake.release()
        return done

    def stop(self) -> None:
        self._job = None
        self._wake.release()

    def _loop(self) -> None:
        while True:
            self._wake.acquire()
            job, self._job = self._job, None
            if job is None:
                return
            fn, done = job
            try:
                fn()
            except BaseException:
                # a job must never corpse the pool thread: device_thread
                # handles its own errors; this is the last-resort guard that
                # keeps a recycled worker alive for the next submit
                pass
            finally:
                done.set()
                self._pool._recycle(self)


class _RunContext:
    """Dispatch state for ONE submitted program (the session's inner engine).

    Owns the scheduler instance, the output buffer (or a caller-supplied
    ``collect`` hook for non-array reductions, e.g. gradient accumulation),
    and the per-run device bookkeeping.  Device threads are pulled from the
    session's WorkerPool; compiled executables come from ``compile_fn``
    (the session's cache).
    """

    def __init__(self, program: Program, devices: Sequence[DeviceGroup], *,
                 scheduler: str, scheduler_kwargs: Dict,
                 compile_fn: Callable[[DeviceGroup], Callable],
                 pool: WorkerPool,
                 registered_buffers: bool = True,
                 buffer_policy: Optional[BufferPolicy] = None,
                 arena: Optional[BufferArena] = None,
                 parallel_init: bool = True,
                 reset_device_stats: bool = True,
                 powers: Optional[List[float]] = None,
                 collect: Optional[Callable] = None,
                 region: Optional[Region] = None,
                 dispatch: str = "leased",
                 journal=None,
                 journal_key: Optional[str] = None,
                 progress=None,
                 progress_key: Optional[object] = None,
                 tenant=None,
                 lease_params: Optional[Dict] = None,
                 async_threshold_bytes: Optional[int] = None):
        self.program = program
        self.devices = list(devices)
        if not self.devices:
            raise RuntimeError(f"{program.name}: no devices to dispatch to")
        if dispatch not in ("leased", "per_packet"):
            raise ValueError(
                f"{program.name}: dispatch must be 'leased' or "
                f"'per_packet', got {dispatch!r}")
        self.dispatch = dispatch
        self.scheduler_name = scheduler
        self.scheduler_kwargs = dict(scheduler_kwargs)
        self.compile_fn = compile_fn
        self.pool = pool
        # buffer_policy supersedes the legacy registered_buffers bool (kept
        # for callers that predate the memory subsystem)
        self.buffer_policy = buffer_policy if buffer_policy is not None \
            else BufferPolicy.from_flag(registered_buffers)
        self.registered_buffers = self.buffer_policy.registered
        self.arena = arena
        self.parallel_init = parallel_init
        self.reset_device_stats = reset_device_stats
        self.powers = list(powers) if powers is not None else None
        self.collect = collect
        # the run's work: a sub-region (the paper's ROI) or the program's
        # full NDRange; containment/alignment is validated at submit time
        self.run_region = region if region is not None \
            else program.work_region
        # persistent run state: every committed packet appends (node key,
        # absolute dim-0 span, output rows) to the journal — the basis of
        # checkpoint/resume (repro_torch.ckpt.checkpoint.RunJournal).  Offsets
        # are journaled relative to the PROGRAM's region start, so a
        # resumed gap sub-run composes with the original run's records.
        self.journal = journal
        self.journal_key = journal_key or program.name
        # per-graph work accounting: the session's GraphProgress learns
        # this run's live scheduler so graph-wide remaining() is exact
        self.progress = progress
        self.progress_key = progress_key
        # multi-tenant arbitration: a TenantHandle whose begin_packet /
        # end_packet bracket every device pull (repro_torch.tenancy).  None =
        # the session owns the fleet (the pre-tenancy fast path, zero
        # overhead: solo runs stay bit-identical).
        self.tenant = tenant
        # calibrated constants (session kwargs / TunedConfig): lease
        # growth-law overrides applied onto the fresh scheduler instance,
        # and the transfer pipeline's inline/async commit crossover
        self.lease_params = dict(lease_params) if lease_params else None
        self.async_threshold_bytes = async_threshold_bytes

    def _invoke(self, fn: Callable, region: Region) -> Callable:
        """Adapt a packet's absolute row panel to the range-fn contract
        (1-D: fn(offset, size); 2-D: fn(row0, n_rows, col0, n_cols))."""
        if region.ndim == 2:
            d0, d1 = region.dims

            def call(_offset, _size):
                return fn(d0.offset, d0.size, d1.offset, d1.size)
        else:
            d0 = region.dims[0]

            def call(_offset, _size):
                return fn(d0.offset, d0.size)
        return call

    def execute(self) -> RunResult:
        clock = PhaseClock()
        clock.mark("start")
        prog = self.program
        run_region = self.run_region
        n = len(self.devices)
        if self.reset_device_stats:
            for d in self.devices:
                d.packets_done = 0
                d.busy_time = 0.0
                d.finish_time = 0.0
                d.dead = False

        output = None
        # output geometry follows the RUN's region (an ROI submit returns
        # just its sub-region, rows relative to the region start)
        out_cols = prog.out_cols if run_region.ndim == 1 \
            else run_region.dims[1].size * prog.out_cols
        pipe: Optional[TransferPipeline] = None
        use_pipeline = self.buffer_policy.pooled and self.collect is None
        if self.collect is None:
            out_rows = run_region.dims[0].size * prog.out_rows_per_wg
            if self.buffer_policy.pooled and self.arena is not None:
                # pooled: the run output is a recycled arena buffer, not a
                # fresh allocation.  No zeroing needed — packets tile the
                # run region exactly, and a commit failure fails the run.
                output = self.arena.acquire(prog.name, "host",
                                            (out_rows, out_cols),
                                            prog.out_dtype).array
            else:
                output = np.zeros((out_rows, out_cols), prog.out_dtype)
        profiles = [DeviceProfile(d.name,
                                  (self.powers[i] if self.powers else
                                   (d.throughput or 1.0 / d.throttle)),
                                  power_model=d.power_model)
                    for i, d in enumerate(self.devices)]
        # per-device commit logs: appended only by the owning device
        # thread (or the committer draining that device's stage-outs), so
        # the dispatch hot path never crosses a run-global lock
        executed_by: List[List] = [[] for _ in range(n)]
        # per-device host<->device traffic (bytes) for the energy meter's
        # transfer term; written only by the owning device thread
        bytes_io: List[float] = [0.0] * n
        errors: List[BaseException] = []
        exec_lock = threading.Lock()      # rare paths: errors, collect
        state: Dict[str, Any] = {"sched": None, "commit_failed": 0}
        ready = threading.Barrier(n + 1)
        compiled_ev = threading.Event()
        fns: List[Optional[Callable]] = [None] * n
        t0_busy = [d.busy_time for d in self.devices]
        if use_pipeline:
            pipe = TransferPipeline(self.pool, self.async_threshold_bytes)
            pipe.start()

        def mark_roi():
            # the ROI window opens when the first packet is ready to
            # compute; ordering after the "compiled" mark keeps the five
            # phase windows disjoint (exact wall-clock identity)
            if clock.at("roi") is None:
                compiled_ev.wait()
                clock.mark_once("roi")

        # multi-tenant arbitration: tb[i] is the begin_packet timestamp
        # that brackets device i's current packet window (written/read
        # only by device i's thread)
        tenant = self.tenant
        tb: List[float] = [0.0] * n

        def pull(i: int) -> Any:
            """The dispatch hot path: leased (local-lease pop, amortized
            lock) or per-packet (the classic hand-off baseline).  Under a
            tenant, every pull first asks the arbiter; a denial reclaims
            the device's lease back to the retry pool (the packet-boundary
            preemption) and reads as an empty pull — the loop's drained()
            protocol keeps the thread polling while work remains."""
            sched = sched_of(i)
            if tenant is not None:
                if not tenant.begin_packet(i):
                    sched.reclaim_lease(i)
                    return None
                tb[i] = time.perf_counter()
                pkt = (sched.acquire(i) if self.dispatch == "leased"
                       else sched.next_packet(i))
                if pkt is None:
                    tenant.end_packet(i, 0, tb[i])
                return pkt
            if self.dispatch == "leased":
                return sched.acquire(i)
            return sched.next_packet(i)

        def tenant_end(i: int, wg: int) -> None:
            """Close device i's tenant packet window (wg=0: the packet was
            requeued, charge nothing).  Must be called exactly once per
            successful begin_packet, on every exit path."""
            if tenant is not None:
                tenant.end_packet(i, wg, tb[i])

        def fetch_and_stage(i: int, fn: Callable):
            """Stage-in for device ``i``: pull the next packet and bind its
            launch (the H2D window's host work)."""
            t0 = time.perf_counter()
            pkt = pull(i)
            if pkt is None:
                return None
            try:
                pkt_region = pkt.region if pkt.region is not None \
                    else run_region.row_panel(pkt.offset, pkt.size)
                call = self._invoke(fn, pkt_region)
            except BaseException:
                # requeue BEFORE release: the packet must never be
                # invisible to the drained() protocol
                sched_of(i).requeue(pkt)
                sched_of(i).release(i)
                tenant_end(i, 0)
                raise
            if pipe is not None:
                pipe.note_h2d(time.perf_counter() - t0)
            return pkt, call

        def sched_of(i: int) -> SchedulerBase:
            return state["sched"]

        # journal offsets are node-relative (program-region dim-0 units),
        # so a resumed gap sub-run's records land in node coordinates
        jbase = (run_region.dims[0].offset
                 - prog.work_region.dims[0].offset)

        def journal_commit(pkt, rows) -> None:
            """Append one committed packet to the run journal (called
            under the packet's commit, before its scheduler release)."""
            if self.journal is not None:
                self.journal.append_packet(self.journal_key,
                                           jbase + pkt.offset, pkt.size,
                                           rows)

        def make_commit(i, pkt, res):
            def commit():
                try:
                    r0 = pkt.offset * prog.out_rows_per_wg
                    r1 = (pkt.offset + pkt.size) * prog.out_rows_per_wg
                    rows = res.detach().cpu().numpy().reshape(
                        r1 - r0, out_cols)
                    output[r0:r1] = rows
                    journal_commit(pkt, rows)
                    executed_by[i].append(("pkt", pkt))
                except Exception as e:
                    # host-side commit failure is fatal for the run: the
                    # packet was accounted done at stage-out, so the drain
                    # check cannot catch it — fail the run explicitly
                    with exec_lock:
                        errors.append(e)
                        state["commit_failed"] += 1
            return commit

        def abort_pipelined(i, pkt, err):
            """Requeue the in-flight packet and release the device (same
            provenance rules as the sync path)."""
            if err is not None:
                with exec_lock:
                    errors.append(err)
            sched = sched_of(i)
            sched.requeue(pkt)
            sched.mark_dead(i)
            sched.release(i)
            tenant_end(i, 0)

        def device_loop_sync(i: int, dev: DeviceGroup, fn: Callable,
                             sched: SchedulerBase):
            # the unregistered-buffer pathology: every packet re-syncs the
            # program's full memory regions — read-only inputs AND the
            # whole output region — on the device thread (real host copies
            # sized by the actual footprints; the sim's BULK_COPY term)
            in_src = in_scratch = None
            stage_bytes = 0
            if not self.registered_buffers:
                stage_bytes = prog.in_bytes + (output.nbytes
                                               if output is not None else 0)
            if stage_bytes > 0:
                in_src = np.empty(stage_bytes, np.uint8)
                in_scratch = np.empty(stage_bytes, np.uint8)
            my_done = executed_by[i]
            staged_in = False
            while True:
                mark_roi()
                pkt = pull(i)
                if pkt is None:
                    # another device may still fail and requeue its
                    # packet: only exit once the scheduler's drain
                    # protocol says nothing is in flight anywhere
                    # (remaining + acquired-but-unreleased claims + the
                    # retry-epoch re-check).  A dying peer keeps its
                    # claim until after it has requeued its packet and
                    # mark_dead has reclaimed its lease, so drained()
                    # stays False for exactly as long as recoverable
                    # work can still appear.
                    if sched.drained():
                        break
                    time.sleep(1e-3)
                    continue
                pkt_region = pkt.region if pkt.region is not None \
                    else run_region.row_panel(pkt.offset, pkt.size)
                if in_src is not None:
                    np.copyto(in_scratch, in_src)     # per-packet bulk copy
                    bytes_io[i] += stage_bytes        # bulk re-stage per pkt
                elif not staged_in:
                    bytes_io[i] += prog.in_bytes      # registered: once/dev
                    staged_in = True
                try:
                    res, wg_s = dev.run_packet(self._invoke(fn, pkt_region),
                                               pkt.offset, pkt.size)
                except DeviceFailure:
                    sched.requeue(pkt)
                    sched.mark_dead(i)
                    sched.release(i)
                    tenant_end(i, 0)
                    break
                except Exception as e:
                    # unexpected executor error: same fault-tolerance path as
                    # a device failure, but the error is surfaced if the run
                    # cannot complete without this device
                    dev.dead = True
                    with exec_lock:
                        errors.append(e)
                    sched.requeue(pkt)
                    sched.mark_dead(i)
                    sched.release(i)
                    tenant_end(i, 0)
                    break
                try:
                    sched.note_packet_latency(i, pkt.size / max(wg_s, 1e-9))
                    if hasattr(sched, "observe"):
                        sched.observe(i, wg_s)
                    if self.collect is not None:
                        with exec_lock:
                            self.collect(pkt, res, dev)
                        my_done.append(("pkt", pkt))
                        sched.release(i)
                        tenant_end(i, pkt.size)
                        continue
                    r0 = pkt.offset * prog.out_rows_per_wg
                    r1 = (pkt.offset + pkt.size) * prog.out_rows_per_wg
                    # explicit readback: a packet's result may live on a
                    # card, which numpy cannot read in place
                    res = res.detach().cpu().numpy().reshape(r1 - r0,
                                                             out_cols)
                    bytes_io[i] += res.nbytes         # result readback
                    if self.registered_buffers:
                        output[r0:r1] = res           # in-place commit
                    else:
                        my_done.append(("copy", r0, r1,
                                        np.array(res, copy=True)))
                    journal_commit(pkt, res)
                    my_done.append(("pkt", pkt))
                    sched.release(i)
                    tenant_end(i, pkt.size)
                except Exception as e:
                    # commit-path failure (mis-shaped result, collect hook,
                    # observe): must release the in-flight packet and mark
                    # the device dead, or the surviving devices spin forever
                    dev.dead = True
                    with exec_lock:
                        errors.append(e)
                    sched.requeue(pkt)
                    sched.mark_dead(i)
                    sched.release(i)
                    tenant_end(i, 0)
                    break

        def device_loop_pipelined(i: int, dev: DeviceGroup, fn: Callable,
                                  sched: SchedulerBase):
            """stage-in -> compute -> stage-out, double-buffered: packet
            k's stage-out is handed to the committer and packet k+1's
            stage-in is issued immediately — the device thread moves on to
            the next compute while the committer drains k's D2H, and never
            blocks on host staging.  (On hosts where stage-in itself is
            heavy, ``TransferPipeline.prefetch`` runs it on a stager
            thread concurrently with compute; the bound launches here are
            host-cheap, so the runtime issues them inline and the
            simulator carries the calibrated H2D-overlap model.)"""
            itemsize = np.dtype(prog.out_dtype).itemsize

            def abort_stage_in(e: BaseException) -> None:
                # a stage-in failure must release the device like any other
                # fatal error — swallowing it would strand a pre-assigned
                # static chunk and livelock the surviving devices
                dev.dead = True
                with exec_lock:
                    errors.append(e)
                    sched.mark_dead(i)

            staged_in = False
            try:
                staged = fetch_and_stage(i, fn)
            except Exception as e:
                abort_stage_in(e)
                return
            while True:
                if staged is None:
                    # same exit protocol as the sync loop
                    if sched.drained():
                        break
                    time.sleep(1e-3)
                    try:
                        staged = fetch_and_stage(i, fn)
                    except Exception as e:
                        abort_stage_in(e)
                        return
                    continue
                pkt, call = staged
                if not staged_in:
                    bytes_io[i] += prog.in_bytes      # arena stage-in, once
                    staged_in = True
                mark_roi()
                try:
                    res, wg_s = dev.run_packet(call, pkt.offset, pkt.size)
                except DeviceFailure:
                    abort_pipelined(i, pkt, None)
                    break
                except Exception as e:
                    dev.dead = True
                    abort_pipelined(i, pkt, e)
                    break
                try:
                    sched.note_packet_latency(i, pkt.size / max(wg_s, 1e-9))
                    if hasattr(sched, "observe"):
                        sched.observe(i, wg_s)
                    nbytes = (pkt.size * prog.out_rows_per_wg * out_cols
                              * itemsize)
                    bytes_io[i] += nbytes             # result readback
                    pipe.stage_out(make_commit(i, pkt, res), nbytes)
                    sched.release(i)
                    tenant_end(i, pkt.size)
                except Exception as e:
                    dev.dead = True
                    abort_pipelined(i, pkt, e)
                    break
                try:
                    staged = fetch_and_stage(i, fn)
                except Exception as e:
                    # stage-in failure (bad geometry): the fetch released
                    # its own accounting; release the device and surface
                    abort_stage_in(e)
                    break

        def device_thread(i: int):
            dev = self.devices[i]
            if self.parallel_init:
                # parallel AOT compile, overlapped with Runtime's prep
                try:
                    fns[i] = self.compile_fn(dev)
                except Exception as e:      # compile failure = dead device
                    dev.dead = True
                    with exec_lock:
                        errors.append(e)
            ready.wait()
            sched: SchedulerBase = state["sched"]
            if sched is None:
                return                        # scheduler construction failed
            fn = fns[i]
            if fn is None:
                sched.mark_dead(i)            # compile failed: release work
                return
            if use_pipeline:
                device_loop_pipelined(i, dev, fn, sched)
            else:
                device_loop_sync(i, dev, fn, sched)
            dev.finish_time = clock.since("roi") if clock.at("roi") else 0.0

        def start_threads() -> List[threading.Event]:
            return [self.pool.submit(_bind(device_thread, i))
                    for i in range(n)]

        def build_scheduler() -> SchedulerBase:
            sched = make_scheduler(self.scheduler_name, run_region,
                                   run_region.dims[0].lws, profiles,
                                   **self.scheduler_kwargs)
            if self.lease_params:
                sched.set_lease_params(**self.lease_params)
            if self.progress is not None:
                # graph-wide remaining() now reads this run's live
                # lease/exact-cover bookkeeping instead of its static G
                self.progress.attach(self.progress_key, sched)
            return sched

        try:
            if self.parallel_init:
                done_events = start_threads()
                # Runtime prepares the scheduler concurrently with compiles
                try:
                    state["sched"] = build_scheduler()
                except BaseException:
                    # release the pooled threads parked at the barrier (they
                    # see sched=None and exit) before surfacing the error —
                    # a raise here must not wedge n workers forever
                    ready.wait()
                    for ev in done_events:
                        ev.wait()
                    raise
                # the barrier releases once every device finished compiling:
                # everything before it is the init phase (compiles
                # overlapped with scheduler prep); the staging (h2d) and
                # ROI windows follow
                ready.wait()
            else:
                # sequential: discovery+compile each device, then scheduler
                for i, d in enumerate(self.devices):
                    try:
                        fns[i] = self.compile_fn(d)
                    except Exception as e:
                        d.dead = True
                        errors.append(e)
                state["sched"] = build_scheduler()
                done_events = start_threads()
                ready.wait()
            clock.mark("compiled")
            compiled_ev.set()
            for ev in done_events:
                ev.wait()
            clock.mark("drained")
            roi_time = clock.between("roi", "drained")
            if pipe is not None:
                # drain the commit tail: everything still on the committer
                # after the queue drained is the run's D2H window
                pipe.flush()
            if state["sched"].remaining() > 0:
                err = RuntimeError(
                    f"{prog.name}: {state['sched'].remaining()} work-groups "
                    "unprocessed — all devices failed")
                if errors:
                    raise err from errors[0]
                raise err
            if state["commit_failed"]:
                err = RuntimeError(
                    f"{prog.name}: {state['commit_failed']} packet "
                    "commit(s) failed on the transfer pipeline")
                if errors:
                    raise err from errors[0]
                raise err
            if self.collect is None and not self.registered_buffers:
                # assemble results from per-packet copies (bulk copy at end)
                for done in executed_by:
                    for item in done:
                        if item[0] == "copy":
                            _, r0, r1, arr = item
                            output[r0:r1] = arr
            clock.mark("assembled")
            packets = [it[1] for done in executed_by for it in done
                       if it[0] == "pkt"]
            clock.mark("end")
        finally:
            if pipe is not None:
                pipe.close()
            if tenant is not None and state["sched"] is not None:
                # per-tenant SchedStats rollup across all of the tenant's
                # runs (carves, steals, reclaims, lock crossings)
                tenant.merge_stats(state["sched"].stats)
        phases = PhaseBreakdown(
            init_s=clock.between("start", "compiled"),
            offload_s=clock.between("compiled", "assembled"),
            roi_s=roi_time,
            teardown_s=clock.between("assembled", "end"),
            h2d_s=clock.between("compiled", "roi"),
            d2h_s=clock.between("drained", "assembled"),
        )
        run_busy = [d.busy_time - b0 for d, b0 in
                    zip(self.devices, t0_busy)]
        # energy: each device is powered for the whole ROI window (idle
        # watts bridge its stalls); a dead device only until it exited.
        # Crossings come from the scheduler's per-device counters — the
        # exact dispatch-path hand-offs this run paid for.
        crossings = state["sched"].lock_crossings_by_device()
        meter = EnergyMeter()
        for i, d in enumerate(self.devices):
            window = d.finish_time if d.dead else roi_time
            meter.add(d.name, d.power_model,
                      busy_s=min(max(run_busy[i], 0.0), window),
                      window_s=window, crossings=crossings[i],
                      bytes_moved=bytes_io[i])
        result = RunResult(
            total_time=roi_time,
            device_busy=run_busy,
            device_finish=[d.finish_time for d in self.devices],
            packets=packets,
            binary_time=clock.between("start", "end"),
            aborted_devices=sum(1 for d in self.devices if d.dead),
            phases=phases,
            sched_wait_s=state["sched"].sched_wait_s(),
            energy=meter.report(),
        )
        result.output = output  # type: ignore[attr-defined]
        return result


def _bind(fn: Callable, i: int) -> Callable[[], None]:
    """Bind the device index without a late-binding closure bug."""
    def bound():
        fn(i)
    return bound
