"""Tier-2: EngineSession — one session, many programs, reused primitives.

The paper's optimizations only pay off when costly primitives (compiled
executables, registered buffers) are *reused across runs*.  The session is
where that reuse lives:

  * an **executable cache** keyed by (program, device) — back-to-back
    submits of the same program pay ``init_cost_s`` at most once per device
    per session, not once per run;
  * a **buffer registry** recording which (program, device) pairs have
    registered input buffers (``BufferPolicy.REGISTERED`` commits outputs
    in place against them);
  * **elastic device membership** across runs (``add_device`` /
    ``remove_device`` renormalize scheduler powers on the next submit);
  * a **WorkerPool** of device threads reused run-to-run;
  * an async **submit graph**: ``submit(program) -> RunHandle`` returns
    immediately, so callers overlap input preparation with in-flight runs
    exactly as the init optimization overlaps compiles.  A submit may name
    predecessor handles (``deps=[h1, h2]``): the session maintains the
    dependency DAG and its **ready-set dispatcher** starts each dependent
    the moment its actual predecessors finish — true DAG dispatch, not
    level-by-level barriers.  Independent submits keep strict FIFO order
    at the default ``max_inflight=1`` (one co-execution owns the fleet at
    a time — the paper's co-execution model); raising ``max_inflight``
    lets several ready runs co-execute over the shared fleet, which is
    what lets a multi-stage pipeline fill one stage's drain tail with the
    next stage's packets.  Predecessor results flow into dependents via
    the ``feed`` hook (called with the deps' RunResults just before
    dispatch), so pooled predecessor outputs are consumed in place —
    inter-stage data never round-trips through fresh staging.  A
    cancelled predecessor cascades (dependents transition to CANCELLED);
    a failed predecessor fails dependents with ``DependencyError``.
  * a **workload registry** for the paper's ROI offloading:
    ``register_workload(program)`` pays init once (executables built,
    buffers registered on every device); subsequent
    ``submit(program, region=..., mode=OffloadMode.ROI)`` calls execute
    sub-regions warm.  ``mode=OffloadMode.BINARY`` is the opposite
    contract: fully self-contained init -> offload -> teardown per submit.

Blocking callers use ``session.run(program)`` or Tier-1
``coexec(program, devices=...)``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.device import DeviceGroup
from repro_torch.core.membuf import ArenaStats, BufferArena
from repro_torch.core.metrics import RunResult
from repro_torch.core.region import Region
from repro_torch.core.runtime import Program, WorkerPool, _RunContext
from repro_torch.core.scheduler import GraphProgress, scheduler_spec
from repro_torch.tenancy.arbiter import FleetArbiter, TenantConfig
from repro_torch.api.handles import DependencyError, RunHandle
from repro_torch.api.policies import BufferPolicy, DevicePolicy, OffloadMode


@dataclass(eq=False)          # identity semantics: queue removal on cancel
class _Submission:
    """Everything one queued run needs, captured at submit time."""
    program: Program
    powers: Optional[List[float]]
    scheduler: str
    scheduler_kwargs: Dict
    cache: bool
    collect: Optional[Callable]
    region: Optional[Region] = None
    mode: Optional[OffloadMode] = None
    buffer_policy: Optional[BufferPolicy] = None
    dispatch: Optional[str] = None
    deps: List[RunHandle] = field(default_factory=list)
    feed: Optional[Callable] = None      # feed(dep_results) before dispatch
    journal: Optional[object] = None     # RunJournal for packet commits
    journal_key: Optional[str] = None
    handle: RunHandle = field(default=None)  # type: ignore[assignment]


class EngineSession:
    """A long-lived co-execution session over an elastic device fleet."""

    def __init__(self, devices: Optional[Sequence[DeviceGroup]] = None, *,
                 scheduler: Optional[str] = None,
                 scheduler_kwargs: Optional[Dict] = None,
                 buffer_policy: BufferPolicy = BufferPolicy.REGISTERED,
                 device_policy: Optional[DevicePolicy] = None,
                 parallel_init: bool = True,
                 cache_executables: bool = True,
                 init_cost_s: float = 0.0,
                 reset_device_stats: bool = True,
                 arena_capacity_bytes: int = 256 << 20,
                 arena_ring: int = 2,
                 dispatch: str = "leased",
                 max_inflight: int = 1,
                 arbiter: Optional[FleetArbiter] = None,
                 tenant: Optional[TenantConfig] = None,
                 lease_overhead_s: Optional[float] = None,
                 lease_overhead_frac: Optional[float] = None,
                 lease_k_max: Optional[int] = None,
                 async_threshold_bytes: Optional[int] = None,
                 tuned=None,
                 name: str = "session"):
        if dispatch not in ("leased", "per_packet"):
            raise ValueError(f"dispatch must be 'leased' or 'per_packet', "
                             f"got {dispatch!r}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {max_inflight}")
        if tenant is not None and arbiter is None:
            raise ValueError("tenant= requires arbiter= (a TenantConfig "
                             "only means something on a shared fleet)")
        # how many READY submits may co-execute at once.  1 (default)
        # preserves strict FIFO: one run owns the fleet at a time.  >1 is
        # the DAG-pipelining mode: a dependent whose predecessors are done
        # co-executes with unrelated runs over the shared fleet.
        self.max_inflight = max_inflight
        self.dispatch = dispatch
        self.device_policy = device_policy or DevicePolicy()
        if devices is None and arbiter is not None:
            # tenant sessions default to the arbiter's fleet
            self._devices: List[DeviceGroup] = list(arbiter.devices)
        else:
            self._devices = self.device_policy.resolve(devices)
        # calibrated-constants path: a TunedConfig (passed directly, as a
        # dict, as a file path, or ``tuned=True`` for a cache lookup by
        # this fleet's fingerprint) supplies DEFAULTS for the scheduler
        # choice, the lease growth law, and the transfer crossover —
        # explicit kwargs always win (repro_torch.tune).
        self.tuned = None
        if tuned is not None and tuned is not False:
            from repro_torch.tune.cache import resolve_tuned
            self.tuned = resolve_tuned(tuned, devices=self._devices)
        if self.tuned is not None:
            t = self.tuned
            if scheduler is None and t.scheduler:
                scheduler = t.scheduler
                if scheduler_kwargs is None and t.scheduler_kwargs:
                    scheduler_kwargs = dict(t.scheduler_kwargs)
            if lease_overhead_s is None:
                lease_overhead_s = t.lease_overhead_s
            if lease_overhead_frac is None:
                lease_overhead_frac = t.lease_overhead_frac
            if lease_k_max is None:
                lease_k_max = t.lease_k_max
            if async_threshold_bytes is None:
                async_threshold_bytes = t.async_threshold_bytes
        scheduler = scheduler or "hguided_opt"
        scheduler_spec(scheduler)            # fail fast on unknown names
        self.scheduler = scheduler
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        # non-None subset applied onto every run's fresh scheduler instance
        self.lease_params = {k: v for k, v in (
            ("lease_overhead_s", lease_overhead_s),
            ("lease_overhead_frac", lease_overhead_frac),
            ("lease_k_max", lease_k_max)) if v is not None} or None
        self.async_threshold_bytes = async_threshold_bytes
        self.buffer_policy = buffer_policy
        self.parallel_init = parallel_init
        self.cache_executables = cache_executables
        # emulated fixed driver-primitive cost paid per executable build;
        # the cache amortizes it across submits (paper's init optimization)
        self.init_cost_s = init_cost_s
        self.reset_device_stats = reset_device_stats
        self.name = name
        self._graph = GraphProgress()
        # multi-tenant mode: the session registers with the arbiter and
        # shares ITS pool + arena (an ArenaPartition namespaces this
        # tenant's keys); every device pull is arbiter-gated.  Solo mode
        # (arbiter=None) keeps the session-owned fast path unchanged.
        self.arbiter = arbiter
        self._tenant = None
        if arbiter is not None:
            tcfg = tenant if tenant is not None else TenantConfig(name=name)
            self._tenant = arbiter.register(
                tcfg, demand=lambda: self._graph.remaining() > 0)
            self.arena = self._tenant.arena
            self._pool = arbiter.pool
            self._owns_pool = False
        else:
            # the memory subsystem: session-owned buffer arena backing
            # POOLED runs (register_workload/evict manage its entries;
            # close drains it)
            self.arena = BufferArena(capacity_bytes=arena_capacity_bytes,
                                     ring=arena_ring, name=f"{name}-arena")
            self._pool = WorkerPool(name=name)
            self._owns_pool = True

        self._executables: Dict[Tuple[str, str], Callable] = {}
        self._buffer_registry: Dict[Tuple[str, str], int] = {}
        self._workloads: Dict[str, Program] = {}   # ROI-registered programs
        self.init_payments = 0               # executable builds performed
        self._lock = threading.Lock()
        # the pending set IS the dependency graph: submissions hold their
        # predecessor handles, and the ready-set dispatcher scans in submit
        # order (FIFO among simultaneously-ready nodes)
        self._pending: List[_Submission] = []
        self._inflight = 0                   # started, not yet terminal
        self._issued: "weakref.WeakSet[RunHandle]" = weakref.WeakSet()
        self._cv = threading.Condition()
        self._closing = False
        self._submitting = 0                 # submit/register calls in body
        self._seq = 0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name=f"{name}-dispatch", daemon=True)
        self._dispatcher.start()

    @property
    def tenant(self):
        """The session's TenantHandle on a shared fleet (None when the
        session owns its devices — the solo fast path)."""
        return self._tenant

    # -- elastic membership --------------------------------------------------
    @property
    def devices(self) -> List[DeviceGroup]:
        with self._lock:
            return list(self._devices)

    def add_device(self, dev: DeviceGroup) -> None:
        with self._lock:
            if any(d.name == dev.name for d in self._devices):
                raise ValueError(f"device {dev.name!r} already in session")
            self._devices.append(dev)

    def remove_device(self, name: str) -> None:
        with self._lock:
            self._devices = [d for d in self._devices if d.name != name]
            for key in [k for k in self._executables if k[1] == name]:
                del self._executables[key]
            for key in [k for k in self._buffer_registry if k[1] == name]:
                del self._buffer_registry[key]

    # -- caches --------------------------------------------------------------
    @property
    def executables(self) -> Dict[Tuple[str, str], Callable]:
        """(program_name, device_name) -> compiled range executable."""
        with self._lock:
            return dict(self._executables)

    @property
    def buffer_registry(self) -> Dict[Tuple[str, str], int]:
        """(program_name, device_name) -> number of buffer registrations
        for cached programs (1 everywhere means full reuse)."""
        with self._lock:
            return dict(self._buffer_registry)

    def evict(self, program_name: str) -> None:
        """Drop a program's cached executables/buffers (all devices) and
        its arena entries (pooled run buffers)."""
        with self._lock:
            for key in [k for k in self._executables
                        if k[0] == program_name]:
                del self._executables[key]
            for key in [k for k in self._buffer_registry
                        if k[0] == program_name]:
                del self._buffer_registry[key]
        self.arena.evict(program_name)

    @property
    def arena_stats(self) -> ArenaStats:
        """Counters/gauges of the session's buffer arena."""
        return self.arena.stats

    # -- workload registry (ROI offloading) ----------------------------------
    @property
    def workloads(self) -> Dict[str, Program]:
        """name -> registered persistent workload (ROI-mode targets)."""
        with self._lock:
            return dict(self._workloads)

    def register_workload(self, program: Program, *,
                          build: bool = True) -> Program:
        """Register ``program`` as a persistent workload and pay init NOW.

        Executables are built (and buffers registered) on every current
        device up front, so subsequent ``mode=OffloadMode.ROI`` submits —
        the paper's repeated sub-region offloads — run warm from the first
        one.  ``build=False`` only records the workload (init is then paid
        lazily by the first submit).  Returns the registered program.
        """
        program.validate()
        self._begin_op()
        try:
            return self._register_workload_op(program, build=build)
        finally:
            self._end_op()

    def _register_workload_op(self, program: Program, *,
                              build: bool) -> Program:
        with self._lock:
            devices = list(self._devices)
        if build:
            # parallel init, same as the dispatch path: registration costs
            # one init window, not n_devices serial ones
            errors: List[BaseException] = []

            def compile_one(dev):
                try:
                    self._compile_for(program, dev, cache=True)
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=compile_one, args=(d,),
                                        daemon=True) for d in devices]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            # pre-populate the arena's output ring for the full-region
            # shape, so even the FIRST pooled ROI submit of the whole
            # workload hits instead of allocating (sub-region ROIs create
            # their own keys on first submit and are warm from the second)
            region = program.work_region
            out_cols = program.out_cols if region.ndim == 1 \
                else region.dims[1].size * program.out_cols
            out_rows = region.dims[0].size * program.out_rows_per_wg
            self.arena.register(program.name, "host", (out_rows, out_cols),
                                program.out_dtype)
        with self._lock:
            self._workloads[program.name] = program
        return program

    def unregister_workload(self, name: str) -> None:
        """Drop a registered workload and evict its cached state."""
        with self._lock:
            self._workloads.pop(name, None)
        self.evict(name)

    def _compile_for(self, program: Program, dev: DeviceGroup,
                     cache: bool) -> Callable:
        key = (program.name, dev.name)
        if cache:
            with self._lock:
                fn = self._executables.get(key)
            if fn is not None:
                return fn
        if self.init_cost_s:
            time.sleep(self.init_cost_s)      # driver primitive cost
        fn = program.build(dev)
        with self._lock:
            self.init_payments += 1
            if cache and self.cache_executables:
                # ephemeral (cache=False) programs must not grow the
                # registries: a serving session submits one uniquely-named
                # round program per dispatch round
                self._executables[key] = fn
                self._buffer_registry[key] = \
                    self._buffer_registry.get(key, 0) + 1
        return fn

    # -- close/submit serialization ------------------------------------------
    def _begin_op(self) -> None:
        """Open a submit/register critical window.  ``close()`` waits for
        every open window before tearing anything down, so an in-flight
        ``submit()`` either completes (and its submission is drained by
        the closing dispatcher) or never passed this gate — the queue
        discard hook can no longer race a concurrent close."""
        with self._cv:
            if self._closing:
                raise RuntimeError(f"session {self.name!r} is closed")
            self._submitting += 1

    def _end_op(self) -> None:
        with self._cv:
            self._submitting -= 1
            self._cv.notify_all()

    # -- submission ----------------------------------------------------------
    def submit(self, program: Program, *,
               powers: Optional[List[float]] = None,
               scheduler: Optional[str] = None,
               scheduler_kwargs: Optional[Dict] = None,
               collect: Optional[Callable] = None,
               cache: bool = True,
               region: Optional[Region] = None,
               mode: Optional[OffloadMode] = None,
               buffer_policy: Optional[BufferPolicy] = None,
               dispatch: Optional[str] = None,
               deps: Optional[Sequence[RunHandle]] = None,
               feed: Optional[Callable] = None,
               journal=None,
               journal_key: Optional[str] = None) -> RunHandle:
        """Enqueue a program; returns a future-like RunHandle immediately.

        ``powers`` overrides the per-device computing powers for this run;
        ``scheduler``/``scheduler_kwargs`` override the session defaults
        (e.g. a serving round's rotated Static order or deadline slack) —
        overriding the scheduler DROPS the session-level kwargs, which were
        tuned for a different class; ``collect(packet, result, device)``
        replaces array output assembly for reduction-style programs
        (called under the run's commit lock); ``cache=False`` skips the
        executable cache for ephemeral programs.

        ``region`` restricts the run to a sub-region of the program's
        NDRange (must be contained and per-dimension lws-aligned within
        it); the result's ``output`` covers just that sub-region.
        ``mode`` selects the paper's offload contract: ``BINARY`` builds
        fresh and tears down after (self-contained one-shot, full init +
        teardown charged to this run's phase breakdown), ``ROI`` requires
        the program to be ``register_workload``-ed and executes warm
        against the registered executables/buffers.

        ``buffer_policy`` overrides the session's buffer handling for this
        run.  ROI submits default to ``BufferPolicy.POOLED`` (arena-backed
        output + overlapped transfer pipeline — note the pooled
        result-lifetime contract: ``output`` is a recycled view, valid
        until the workload's ring cycles); everything else defaults to the
        session policy.

        ``dispatch`` overrides the session's scheduler hand-off mode for
        this run: ``"leased"`` (default — lease-amortized packet plans
        with the scheduler's adaptive ``lease``/``acquire`` path) or
        ``"per_packet"`` (one lock crossing per packet, the measurable
        baseline).

        ``deps`` lists predecessor RunHandles from THIS session: the run
        stays pending until every predecessor succeeds, then dispatches
        the moment the last one finishes (ready-set DAG dispatch — no
        level barriers).  A cancelled predecessor cascades (this handle
        transitions to CANCELLED); a failed one fails this handle with
        :class:`DependencyError`.  ``feed(dep_results)`` — if given — is
        called on the dispatch thread with the predecessors' RunResults
        (in ``deps`` order) just before init, so the program's closures
        can consume predecessor outputs in place; a ``feed`` that raises
        fails this run (and, transitively, its dependents).

        ``journal`` is a ``repro_torch.ckpt.RunJournal``: every committed
        packet is appended (offset/size in the program's dim-0 frame under
        ``journal_key``, default the program name) so a killed graph can
        be resumed via ``repro_torch.ckpt.resume_run`` executing only
        never-committed packets.
        """
        self._begin_op()
        try:
            return self._submit_locked_out(
                program, powers=powers, scheduler=scheduler,
                scheduler_kwargs=scheduler_kwargs, collect=collect,
                cache=cache, region=region, mode=mode,
                buffer_policy=buffer_policy, dispatch=dispatch,
                deps=deps, feed=feed, journal=journal,
                journal_key=journal_key)
        finally:
            self._end_op()

    def _submit_locked_out(self, program: Program, *,
                           powers, scheduler, scheduler_kwargs, collect,
                           cache, region, mode, buffer_policy, dispatch,
                           deps, feed, journal, journal_key) -> RunHandle:
        """``submit`` body, running inside a ``_begin_op`` window (the
        close/submit serialization gate)."""
        program.validate()
        if scheduler is not None:
            scheduler_spec(scheduler)        # fail fast, not in dispatcher
        if dispatch is not None and dispatch not in ("leased", "per_packet"):
            raise ValueError(
                f"{program.name}: dispatch must be 'leased' or "
                f"'per_packet', got {dispatch!r}")
        if mode is OffloadMode.ROI:
            with self._lock:
                registered = self._workloads.get(program.name)
            if registered is None:
                raise RuntimeError(
                    f"ROI submit of {program.name!r}: not a registered "
                    "workload — call session.register_workload(program) "
                    "first (ROI offloading reuses its executables and "
                    "buffers)")
            if registered is not program:
                # names key the caches: silently running the registered
                # instance's buffers for a different program object would
                # return the wrong data with no error
                raise ValueError(
                    f"ROI submit of {program.name!r}: a different program "
                    "instance is registered under this name; submit the "
                    "instance register_workload returned, or "
                    "unregister_workload first")
            cache = True
        elif mode is OffloadMode.BINARY:
            with self._lock:
                registered_name = program.name in self._workloads
            if registered_name:
                raise ValueError(
                    f"BINARY submit of {program.name!r}: it is a "
                    "registered workload, and BINARY teardown would "
                    "silently de-warm its ROI submits — "
                    "unregister_workload first")
            cache = False                    # init is paid by THIS run
        if region is not None:
            full = program.work_region
            if region.ndim != full.ndim:
                raise ValueError(
                    f"{program.name}: region {region} has {region.ndim} "
                    f"dims, program NDRange {full} has {full.ndim}")
            if not full.contains(region):
                raise ValueError(f"{program.name}: region {region} not "
                                 f"contained in program NDRange {full}")
            if not region.aligned_within(full):
                raise ValueError(
                    f"{program.name}: region {region} is not lws-aligned "
                    f"within {full} (per-dimension lws "
                    f"{tuple(d.lws for d in full.dims)})")
        if scheduler_kwargs is not None:
            skw = dict(scheduler_kwargs)
        elif scheduler is None or scheduler == self.scheduler:
            skw = dict(self.scheduler_kwargs)
        else:
            skw = {}
        if buffer_policy is None and mode is OffloadMode.ROI:
            # pooled is the default for warm ROI submits: that is where
            # buffer reuse and transfer overlap actually pay off
            buffer_policy = BufferPolicy.POOLED
        dep_list = list(deps or [])
        for d in dep_list:
            if not isinstance(d, RunHandle):
                raise TypeError(
                    f"{program.name}: deps must be RunHandles, got {d!r}")
            if d not in self._issued:
                raise ValueError(
                    f"{program.name}: dep {d!r} was not issued by this "
                    "session — cross-session dependencies are not "
                    "supported (the dispatcher could not drain them)")
        if feed is not None and not callable(feed):
            raise TypeError(f"{program.name}: feed must be callable")
        sub = _Submission(
            program=program, powers=powers,
            scheduler=scheduler or self.scheduler,
            scheduler_kwargs=skw,
            cache=cache, collect=collect,
            region=region, mode=mode,
            buffer_policy=buffer_policy,
            dispatch=dispatch,
            deps=dep_list, feed=feed,
            journal=journal, journal_key=journal_key)
        work = (region if region is not None
                else program.work_region).dims[0].size
        with self._cv:
            # no _closing re-check: this thread holds a _begin_op window,
            # so a concurrent close() waits for it — the submission lands
            # in the queue and is drained by the closing dispatcher
            sub.handle = RunHandle(program.name, self._seq,
                                   discard=lambda: self._discard(sub),
                                   deps=dep_list)
            self._seq += 1
            self._pending.append(sub)
            self._issued.add(sub.handle)
            # graph-wide accounting: static dim-0 total until the run
            # context attaches its live scheduler (see GraphProgress)
            self._graph.register(sub.handle, work)
            self._cv.notify_all()
        return sub.handle

    def _discard(self, sub: _Submission) -> None:
        """Remove a cancelled submission from the pending set (it must not
        wait for — nor pay — dispatch).  Wakes the dispatcher so the
        cancel cascades to dependents immediately."""
        with self._cv:
            try:
                self._pending.remove(sub)
            except ValueError:
                pass                          # already popped by dispatch
            self._cv.notify_all()
        self._graph.complete(sub.handle)

    def run(self, program: Program, **kw) -> RunResult:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(program, **kw).result()

    # -- dispatch ------------------------------------------------------------
    def _next_action_locked(self) -> Optional[Tuple[str, _Submission]]:
        """Scan the pending set (submit order) for the first actionable
        node.  Called under ``self._cv``; pops the submission it returns.

        Ready-set state machine per pending node:
          * any predecessor CANCELLED  -> ``("cancel", sub)`` — cascade;
          * any predecessor failed     -> ``("dep_failed", sub)``;
          * all predecessors succeeded -> ``("run", sub)`` iff an inflight
            slot is free (no deps == trivially ready);
          * otherwise the node stays pending.
        """
        for sub in list(self._pending):
            if any(d.cancelled() for d in sub.deps):
                self._pending.remove(sub)
                return ("cancel", sub)
            if any(d.failed() for d in sub.deps):
                self._pending.remove(sub)
                return ("dep_failed", sub)
            if (self._inflight < self.max_inflight
                    and all(d.succeeded() for d in sub.deps)):
                self._pending.remove(sub)
                return ("run", sub)
        return None

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                action = self._next_action_locked()
                while action is None:
                    if (self._closing and not self._pending
                            and self._inflight == 0
                            and self._submitting == 0):
                        # closing, graph drained, and no submit/register
                        # still inside its _begin_op window
                        return
                    self._cv.wait()
                    action = self._next_action_locked()
                kind, sub = action
                if kind == "run":
                    self._inflight += 1
            if kind == "cancel":
                # predecessor cancelled -> this node cancels too; its own
                # dependents cascade on the next scan (transitively)
                sub.handle._cascade_cancel()
                self._graph.complete(sub.handle)
            elif kind == "dep_failed":
                failed = next(d for d in sub.deps if d.failed())
                exc = DependencyError(sub.program.name,
                                      failed.program_name,
                                      cause=failed._exception)
                exc.__cause__ = failed._exception
                sub.handle._set_exception(exc)
                self._graph.complete(sub.handle)
            elif not sub.handle._start():     # cancelled while pending
                self._graph.complete(sub.handle)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
            else:
                self._pool.submit(self._runner(sub))

    def _runner(self, sub: _Submission) -> Callable[[], None]:
        """Job body for one started node: feed predecessor results, run,
        settle the handle, free the inflight slot."""
        def job() -> None:
            try:
                if sub.feed is not None:
                    sub.feed([d.result(timeout=0) for d in sub.deps])
                sub.handle._set_result(self._execute(sub))
            except BaseException as e:        # surfaced via handle.result()
                sub.handle._set_exception(e)
            finally:
                self._graph.complete(sub.handle)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
        return job

    def remaining_work(self) -> int:
        """Outstanding dim-0 work across every non-terminal submit of the
        session's graph: in-flight runs report their schedulers' exact
        lease/retry/pool accounting, pending nodes their static totals."""
        return self._graph.remaining()

    def _execute(self, sub: _Submission) -> RunResult:
        with self._lock:
            devices = [d for d in self._devices
                       if self.reset_device_stats or not d.dead]
        if not devices:
            raise RuntimeError(
                f"{sub.program.name}: session has no live devices")
        if sub.powers is not None and len(sub.powers) != len(devices):
            raise ValueError(
                f"{sub.program.name}: got {len(sub.powers)} powers for "
                f"{len(devices)} devices")
        policy = sub.buffer_policy if sub.buffer_policy is not None \
            else self.buffer_policy
        ctx = _RunContext(
            sub.program, devices,
            scheduler=sub.scheduler,
            scheduler_kwargs=sub.scheduler_kwargs,
            compile_fn=lambda dev: self._compile_for(sub.program, dev,
                                                     sub.cache),
            pool=self._pool,
            buffer_policy=policy,
            arena=self.arena if policy.pooled else None,
            parallel_init=self.parallel_init,
            reset_device_stats=self.reset_device_stats,
            powers=sub.powers,
            collect=sub.collect,
            region=sub.region,
            dispatch=sub.dispatch or self.dispatch,
            journal=sub.journal,
            journal_key=sub.journal_key,
            progress=self._graph,
            progress_key=sub.handle,
            tenant=self._tenant,
            lease_params=self.lease_params,
            async_threshold_bytes=self.async_threshold_bytes)
        if self._tenant is not None:
            # run brackets: exclusive tenants fence the fleet here, and
            # the arbiter catches the tenant's virtual time up on
            # idle->active so sleepers don't hoard credit
            self._tenant.begin_run()
            try:
                result = ctx.execute()
            finally:
                self._tenant.end_run()
        else:
            result = ctx.execute()
        if sub.mode is OffloadMode.BINARY:
            # the binary contract tears down per submit: evict anything
            # cached under this name (stale earlier registrations included)
            # and charge the eviction to this run's teardown phase
            t0 = time.perf_counter()
            self.evict(sub.program.name)
            extra = time.perf_counter() - t0
            if result.phases is not None:
                result.phases = dataclasses.replace(
                    result.phases,
                    teardown_s=result.phases.teardown_s + extra)
                result.binary_time = result.phases.binary
        return result

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Drain the pending graph, release the arena, stop the pool — in
        that order.  The dispatcher drains every pending submission in
        topological order (dependents run after — or fail/cancel cleanly
        with — their predecessors; no queued ``_Submission`` leaks), and
        the graph must drain *before* the arena closes (an in-flight
        pooled run acquires from it) and the arena must release its
        entries *before* ``WorkerPool.close()`` — a close racing in-flight
        submits must not leak arena entries behind a dead pool."""
        with self._cv:
            if self._closing:
                return
            self._closing = True
            self._cv.notify_all()
        self._dispatcher.join()              # drains graph + open submits
        if self._tenant is not None:
            # tenant mode: retire from the arbiter (drops this tenant's
            # arena partition keys); the SHARED arena/pool stay open for
            # co-tenants and are closed by FleetArbiter.close()
            self.arbiter.unregister(self._tenant)
        else:
            self.arena.close()               # pooled buffers released
        if self._owns_pool:
            self._pool.close()

    def __enter__(self) -> "EngineSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"EngineSession({self.name!r}, devices="
                f"{[d.name for d in self.devices]}, "
                f"scheduler={self.scheduler!r}, "
                f"cached={len(self._executables)})")
