"""Discrete-event co-execution simulator.

The threaded Engine (core/runtime.py) runs the real code paths, but on a
fleet of identical executors relative device speeds can't be reproduced
in wall-clock.  The simulator executes the *same scheduler objects* against
calibrated device models instead, which (a) reproduces the paper's
CPU/iGPU/GPU testbed faithfully, and (b) scales the evaluation to 1000+
device groups (elastic joins, failures, stragglers) in milliseconds.

Device model (per packet of size s work-groups starting at offset o):

    t = launch_overhead + s / throughput(o, s) [+ transfer costs]

* ``throughput(o, s)`` supports *irregular* programs (Ray, Mandelbrot): the
  per-work-group cost varies across the range, which is exactly what makes
  Static mis-balance in the paper.
* ``launch_overhead`` models the per-packet management/synchronization cost
  (host thread, runtime queueing).  More packets => more overhead: the
  Dynamic-with-512-chunks pathology.
* init/teardown constants model the binary-mode costs; the ``opt_init`` /
  ``opt_buffers`` flags change them (and the per-packet transfer term)
  according to the measured effects of the paper's optimizations.

Events are device-completion times in a heap; the scheduler is consulted
exactly as in the threaded runtime (same next_packet/observe/requeue API).
Failures: a device dies at ``fail_at`` seconds; its in-flight packet is
requeued (fault tolerance) — stragglers: throughput multiplier drops at a
given time.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

from repro_torch.core.metrics import PhaseBreakdown, RunResult
from repro_torch.core.scheduler import (DeviceProfile, make_scheduler,
                                  rotate_static_order)
from repro_torch.energy.meter import EnergyMeter, EnergyReport
from repro_torch.energy.model import ZERO_POWER, PowerModel

# fraction of the input set that is full-size read-only buffers, re-copied
# per packet by the unoptimized buffer path
BULK_COPY_FRACTION = 0.45


class PacketCost(NamedTuple):
    """One packet's modeled cost, with its busy/stall split exposed.

    ``t`` is the wall time charged to the device's event timeline;
    ``h2d``/``d2h`` are the unhidden transfer components of it (phase
    observability).  ``busy_s`` is the slice of ``t`` the device spends
    *executing* (launch + compute); ``stall_s`` is the rest — unhidden
    transfer time the device waits out at idle watts.  The energy meter
    reads the split directly instead of re-deriving it from the transfer
    terms (``t == busy_s + stall_s`` exactly)."""
    t: float
    h2d: float
    d2h: float
    busy_s: float
    stall_s: float


@dataclass
class SimDevice:
    name: str
    throughput: float                      # work-groups / second (base)
    launch_overhead: float = 2e-4          # s per packet
    transfer_in: float = 0.0               # s per work-group of input
    transfer_out: float = 0.0              # s per work-group of output
    # irregularity: relative cost multiplier across the work range [0,1]
    irregularity: Optional[Callable[[float], float]] = None
    fail_at: Optional[float] = None        # hard failure time (s)
    straggle_at: Optional[float] = None    # throughput drops at this time
    straggle_factor: float = 1.0           # multiplier after straggle_at
    zero_copy: bool = False                # shares host memory (iGPU/CPU)
    # what the *scheduler profile* believes this device's power is, relative
    # to truth (offline profiling bias).  Static pays the full price of a
    # wrong profile; guided schedulers adapt via their shrinking tail.
    profile_bias: float = 1.0
    # per-packet multiplicative execution-time jitter (lognormal sigma)
    jitter: float = 0.0
    # energy model (busy/idle W, lock J, transfer J/byte); all-zero default
    # keeps every joule-blind config bit-identical with energy == 0
    power_model: PowerModel = ZERO_POWER
    # byte-traffic model for the transfer-energy term: a one-time stage-in
    # footprint (the program's read-only inputs) plus per-work-group
    # result bytes.  Zero-copy devices move no bytes under the
    # registered/pooled policies (same rule as the time model).
    stage_in_bytes: float = 0.0
    xfer_bytes_per_wg: float = 0.0

    def packet_bytes(self, size: int, policy: str, first: bool) -> float:
        """Bytes moved host<->device by one packet under ``policy`` (the
        energy meter's traffic term, mirroring the threaded loops): the
        per-packet path bulk re-stages the full input footprint every
        packet; registered/pooled stage it once per device and move only
        the packet's own result bytes; zero-copy devices move nothing
        except under the per-packet worst practice."""
        if policy == "per_packet":
            return self.stage_in_bytes + size * self.xfer_bytes_per_wg
        if self.zero_copy:
            return 0.0
        return (self.stage_in_bytes if first else 0.0) \
            + size * self.xfer_bytes_per_wg

    def packet_cost(self, offset: int, size: int, total: int, now: float,
                    policy: str, first: bool = True) -> PacketCost:
        """Per-packet cost under a buffer policy.

        Returns a :class:`PacketCost` ``(t, h2d_unhidden, d2h_unhidden,
        busy_s, stall_s)``: the wall time charged to the device's event
        timeline, the transfer components of it that could NOT be hidden
        behind compute (phase observability), and the busy/stall split of
        ``t`` (energy observability).

        * ``per_packet`` — every packet pays its range transfers PLUS the
          bulk re-copy of the full-size read-only inputs (the paper's
          OpenCL worst practice), all serialized.
        * ``registered`` — the paper's buffer-flag optimization: zero-copy
          on shared-memory devices, only the necessary per-range copy on
          discrete ones — still serialized with compute.
        * ``pooled`` — registered plus the double-buffered transfer
          pipeline: packet k+1's H2D and packet k's D2H overlap packet
          k's compute, so only the transfer *exceeding* the compute window
          is charged — except the first packet's stage-in (``first``),
          which has nothing to hide behind (the pipeline fill).
        """
        # irregular work density integrated over the packet's range
        if self.irregularity is not None and total > 0:
            steps = 8
            acc = 0.0
            for i in range(steps):
                x = (offset + size * (i + 0.5) / steps) / total
                acc += self.irregularity(x)
            density = acc / steps
        else:
            density = 1.0
        # piecewise straggling: work done before straggle_at runs at full
        # speed, the remainder at straggle_factor (a packet spanning the
        # slowdown pays for its tail — this is what makes pre-assigned
        # static chunks so expensive under stragglers)
        d0 = size * density / self.throughput
        if self.straggle_at is not None:
            if now >= self.straggle_at:
                d0 = d0 / self.straggle_factor
            elif now + d0 > self.straggle_at:
                done = self.straggle_at - now
                d0 = done + (d0 - done) / self.straggle_factor
        t = self.launch_overhead + d0
        xin = self.transfer_in * size
        xout = self.transfer_out * size
        if policy == "per_packet":
            # without the flags EVERY PACKET bulk-copies the full-size
            # read-only inputs (the paper's "unnecessary complete bulk
            # copies of memory regions") — cost scales with the TOTAL
            # problem size per packet, which is what penalizes co-execution
            # (many packets) far more than a single-device run (one packet)
            h2d = xin + BULK_COPY_FRACTION * self.transfer_in * total
            d2h = xout + BULK_COPY_FRACTION * self.transfer_out * total
            return PacketCost(t + h2d + d2h, h2d, d2h, t, h2d + d2h)
        if self.zero_copy:
            # shared-memory device: the registered/pooled paths are both
            # zero-copy — there is nothing to transfer or overlap
            return PacketCost(t, 0.0, 0.0, t, 0.0)
        if policy == "registered":
            return PacketCost(t + xin + xout, xin, xout, t, xin + xout)
        # pooled: double-buffered staging — steady-state transfers hide
        # behind the compute window; the pipeline fill (the first packet's
        # stage-in, which strictly precedes its own compute) cannot
        assert policy == "pooled", policy
        if first:
            h2d = xin
            d2h = max(0.0, xout - d0)
        else:
            over = max(0.0, xin + xout - d0)
            share = xin / (xin + xout) if (xin + xout) > 0 else 0.0
            h2d = over * share
            d2h = over - h2d
        return PacketCost(t + h2d + d2h, h2d, d2h, t, h2d + d2h)

    def packet_time(self, offset: int, size: int, total: int, now: float,
                    opt_buffers: bool) -> float:
        """Legacy boolean-flag entry point (kept for the single-device
        baseline and pre-membuf callers)."""
        policy = "registered" if opt_buffers else "per_packet"
        return self.packet_cost(offset, size, total, now, policy)[0]


@dataclass
class SimConfig:
    scheduler: str = "hguided"
    scheduler_kwargs: Dict = field(default_factory=dict)
    opt_init: bool = False
    opt_buffers: bool = False
    # buffer policy name ("per_packet" / "registered" / "pooled"); None
    # keeps the legacy opt_buffers mapping.  "pooled" adds the transfer
    # pipeline's DMA/compute overlap to the registered-buffer model.
    buffer_policy: Optional[str] = None
    # binary-mode constants (paper Fig. 6: ~constant offset per run)
    init_cost: float = 0.230               # s, unoptimized init+release
    init_cost_optimized: float = 0.099     # s, saves ~131 ms (paper §V-B)
    # co-execution-only synchronization cost (scheduler start/stop barriers,
    # host-thread management): not paid by a single-device run
    sync_cost: float = 0.105
    sync_cost_optimized: float = 0.085
    # serialized host cost per packet launch (Runtime+Scheduler are host
    # threads; every launch crosses them — the paper's "the more packages
    # ... the more management ... incurring in more overheads")
    host_cost_per_packet: float = 1.0e-3
    # scheduler hand-off model: "per_packet" serializes EVERY launch
    # through the host (one lock crossing per packet — the calibrated
    # paper behavior); "leased" charges the host crossing only when a
    # granted pull actually crossed the scheduler's global lock (lease
    # refills, steals) — local lease pops are free, reproducing the
    # threaded engine's lock-amortized dispatch and its measured
    # crossover (benchmarks/sched_overhead.py).  Terminal empty probes
    # are uncharged in BOTH modes (a device's exit probe costs the same
    # either way), keeping the comparison fair.
    dispatch: str = "per_packet"
    # cost of ONE scheduler lock crossing (contended hand-off / thread
    # wake); None keeps the legacy host_cost_per_packet scale
    sched_overhead_s: Optional[float] = None
    # lease growth-law overrides (None keeps SchedulerBase defaults) —
    # the autotuner sweeps these in-sim before confirming on hardware
    lease_overhead_frac: Optional[float] = None
    lease_k_max: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        # fail fast like the engine: a typo'd mode must not silently
        # fall back to the per-packet model and corrupt a comparison
        if self.dispatch not in ("per_packet", "leased"):
            raise ValueError(f"SimConfig.dispatch must be 'per_packet' or "
                             f"'leased', got {self.dispatch!r}")

    @property
    def policy(self) -> str:
        """Effective buffer policy name."""
        if self.buffer_policy is not None:
            return self.buffer_policy
        return "registered" if self.opt_buffers else "per_packet"

    @property
    def hand_off_cost(self) -> float:
        """Host cost of one scheduler lock crossing."""
        if self.sched_overhead_s is not None:
            return self.sched_overhead_s
        return self.host_cost_per_packet

    def tune_scheduler(self, sched) -> None:
        """Apply the leased-dispatch cost model to a fresh scheduler: the
        adaptive lease law balances lock-crossing cost against packet
        latency, so it must see the MODELED crossing cost (not the
        wall-clock class default) plus any swept growth-law constants."""
        if self.dispatch == "leased":
            sched.set_lease_params(
                lease_overhead_s=self.hand_off_cost,
                lease_overhead_frac=self.lease_overhead_frac,
                lease_k_max=self.lease_k_max)


def simulate(total_work: int, lws: int, devices: Sequence[SimDevice],
             cfg: SimConfig) -> RunResult:
    import random
    rng = random.Random(cfg.seed)
    policy = cfg.policy
    leased = cfg.dispatch == "leased"
    hand_off = cfg.hand_off_cost
    profiles = [DeviceProfile(d.name, d.throughput * d.profile_bias,
                              power_model=d.power_model)
                for d in devices]
    sched = make_scheduler(cfg.scheduler, total_work, lws, profiles,
                           **cfg.scheduler_kwargs)
    cfg.tune_scheduler(sched)
    n = len(devices)
    busy = [0.0] * n
    finish = [0.0] * n
    swait = [0.0] * n                      # modeled scheduler hand-off wait
    first = [True] * n                     # pipeline fill per device
    packets: List = []
    heap: List[Tuple[float, int]] = []     # (ready_time, device)
    for i in range(n):
        heapq.heappush(heap, (0.0, i))
    dead = [False] * n
    h2d_total = 0.0
    d2h_total = 0.0
    cbusy = [0.0] * n                      # executing seconds (energy busy)
    bytes_moved = [0.0] * n                # host<->device traffic (energy)

    host_free = 0.0
    while heap:
        t, i = heapq.heappop(heap)
        d = devices[i]
        if dead[i]:
            continue
        c0 = sched.stats.lock_crossings
        pkt = sched.acquire(i) if leased else sched.next_packet(i)
        crossings = sched.stats.lock_crossings - c0
        if pkt is None:
            finish[i] = max(finish[i], t)
            continue
        # launches serialize through the host Runtime/Scheduler threads —
        # under "leased" dispatch only when the scheduler crossed its
        # global lock (refills/steals); local lease pops are free
        if crossings:
            start = max(t, host_free)
            host_free = start + crossings * hand_off
        else:
            start = t
        swait[i] += start - t
        was_first = first[i]
        cost = d.packet_cost(pkt.offset, pkt.size, total_work,
                             start, policy, first[i])
        first[i] = False
        raw_dt = cost.t + (start - t)
        dt = raw_dt
        if d.jitter > 0:
            dt *= math.exp(rng.gauss(0.0, d.jitter))
        end = t + dt
        if d.fail_at is not None and end > d.fail_at >= t:
            # device dies mid-packet: requeue, mark dead (releases the
            # device's lease and any pre-assigned unclaimed chunk)
            dead[i] = True
            finish[i] = d.fail_at
            sched.requeue(pkt)
            sched.release(i)
            sched.mark_dead(i)
            # wake an idle survivor (if any already drained the queue)
            for j in range(n):
                if not dead[j]:
                    heapq.heappush(heap, (max(d.fail_at, finish[j]), j))
            continue
        busy[i] += dt
        finish[i] = end
        packets.append(pkt)
        h2d_total += cost.h2d
        d2h_total += cost.d2h
        # energy: the jitter multiplier stretches the whole event, so the
        # packet's busy slice stretches with it (same busy:stall ratio)
        cbusy[i] += cost.busy_s * (dt / raw_dt if raw_dt > 0 else 1.0)
        bytes_moved[i] += d.packet_bytes(pkt.size, policy, was_first)
        sched.note_packet_latency(i, dt)   # drives the adaptive lease size
        if hasattr(sched, "observe"):
            sched.observe(i, pkt.size / max(dt, 1e-12))
        sched.release(i)
        heapq.heappush(heap, (end, i))

    if sched.remaining() > 0:
        raise RuntimeError("all devices failed with work remaining")
    roi = max(finish)
    if n > 1:  # co-execution pays the host synchronization cost
        roi += cfg.sync_cost_optimized if cfg.opt_init else cfg.sync_cost
    init = cfg.init_cost_optimized if cfg.opt_init else cfg.init_cost
    # energy: every device is powered for the whole ROI window (idle watts
    # fill the gap between its busy seconds and the window); a dead device
    # is powered only until its failure time.  Lock-crossing energy uses
    # the scheduler's per-device crossing counters — the same counters the
    # dispatch model charges wall time for.
    crossings = sched.lock_crossings_by_device()
    meter = EnergyMeter()
    for i, d in enumerate(devices):
        window = min(roi, d.fail_at) if dead[i] else roi
        meter.add(d.name, d.power_model, busy_s=min(cbusy[i], window),
                  window_s=window, crossings=crossings[i],
                  bytes_moved=bytes_moved[i])
    # h2d/d2h are the UNHIDDEN transfer components already charged inside
    # the event timeline (the simulator's offload window == its ROI
    # window); under "pooled" the pipeline shrinks them toward the fill
    return RunResult(total_time=roi, device_busy=busy, device_finish=finish,
                     packets=packets, binary_time=roi + init,
                     aborted_devices=sum(dead),
                     phases=PhaseBreakdown(init_s=init, offload_s=roi,
                                           roi_s=roi, h2d_s=h2d_total,
                                           d2h_s=d2h_total),
                     sched_wait_s=swait, energy=meter.report())


def single_device_time(total_work: int, lws: int, device: SimDevice,
                       cfg: Optional[SimConfig] = None) -> float:
    """Whole problem on one device, one packet (the paper's baseline)."""
    cfg = cfg or SimConfig()
    return device.packet_time(0, total_work, total_work, 0.0,
                              cfg.opt_buffers)


# ---------------------------------------------------------------------------
# DAG-aware simulation: the EngineSession ready-set dispatcher's twin.
# ---------------------------------------------------------------------------

@dataclass
class SimNode:
    """One node of a simulated run graph: a co-executable range plus the
    names of its predecessor nodes."""
    name: str
    total_work: int
    lws: int = 1
    deps: Tuple[str, ...] = ()


@dataclass
class DagSimResult:
    makespan: float
    node_finish: Dict[str, float]
    node_start: Dict[str, float]
    device_busy: List[float]
    depth: Dict[str, int]                  # node -> DAG level


def dag_depths(nodes: Sequence[SimNode]) -> Dict[str, int]:
    """Longest-path depth of every node (0 for roots); raises on cycles
    or unknown dep names."""
    by_name = {n.name: n for n in nodes}
    if len(by_name) != len(nodes):
        raise ValueError("duplicate node names")
    depth: Dict[str, int] = {}

    def visit(name: str, stack: Tuple[str, ...]) -> int:
        if name in depth:
            return depth[name]
        if name in stack:
            raise ValueError(f"dependency cycle through {name!r}")
        node = by_name.get(name)
        if node is None:
            raise ValueError(f"unknown dep {name!r}")
        d = 0 if not node.deps else 1 + max(
            visit(p, stack + (name,)) for p in node.deps)
        depth[name] = d
        return d

    for n in nodes:
        visit(n.name, ())
    return depth


def simulate_dag(nodes: Sequence[SimNode], devices: Sequence[SimDevice],
                 cfg: SimConfig, *,
                 dispatch_mode: str = "deps") -> DagSimResult:
    """Discrete-event execution of a run graph over a shared fleet.

    The threaded twin is ``EngineSession(max_inflight=n)`` with
    ``submit(..., deps=...)``: every *active* node owns its own scheduler
    instance (exactly like one ``_RunContext`` per submit) and a free
    device pulls from the earliest-submitted active node that still has
    work, so concurrently-ready nodes co-execute over the same devices.

    ``dispatch_mode`` selects the readiness rule under comparison:

    * ``"deps"``  — ready-set dispatch: a node activates the instant its
      actual predecessors finish (the session's DAG dispatcher);
    * ``"levels"`` — level-barrier dispatch: a node activates only once
      EVERY node of lower depth has finished (the classic breadth-first
      baseline the benchmark beats — a barrier drains the fleet to idle
      at each level boundary and the largest node gates its whole level).

    Healthy-fleet model: per-packet costs, irregularity, jitter and the
    buffer-policy transfer model are simulate()'s; failure/straggler
    injection stays with the single-run ``simulate``.
    """
    import random
    if dispatch_mode not in ("deps", "levels"):
        raise ValueError(f"dispatch_mode must be 'deps' or 'levels', "
                         f"got {dispatch_mode!r}")
    rng = random.Random(cfg.seed)
    depth = dag_depths(nodes)
    policy = cfg.policy
    leased = cfg.dispatch == "leased"
    hand_off = cfg.hand_off_cost
    n_dev = len(devices)
    profiles = [DeviceProfile(d.name, d.throughput * d.profile_bias,
                              power_model=d.power_model)
                for d in devices]

    finished: Dict[str, float] = {}
    started: Dict[str, float] = {}
    scheds: Dict[str, object] = {}         # active node -> scheduler
    max_end: Dict[str, float] = {}         # active node -> latest packet end
    first = [True] * n_dev                 # pipeline fill per device

    def ready(node: SimNode, now: float) -> bool:
        if dispatch_mode == "deps":
            return all(p in finished for p in node.deps)
        return all(finished.get(m.name) is not None
                   for m in nodes if depth[m.name] < depth[node.name])

    def activate(now: float) -> bool:
        woke = False
        for node in nodes:                 # submit order == FIFO priority
            if node.name in scheds or node.name in finished:
                continue
            if ready(node, now):
                sched = make_scheduler(cfg.scheduler, node.total_work,
                                       node.lws, profiles,
                                       **cfg.scheduler_kwargs)
                cfg.tune_scheduler(sched)
                scheds[node.name] = sched
                max_end[node.name] = now
                started[node.name] = now
                woke = True
        return woke

    activate(0.0)
    busy = [0.0] * n_dev
    free = [0.0] * n_dev
    heap: List[Tuple[float, int]] = [(0.0, i) for i in range(n_dev)]
    heapq.heapify(heap)
    idle: List[int] = []
    host_free = 0.0

    while heap:
        t, i = heapq.heappop(heap)
        d = devices[i]
        # pull from the earliest-submitted active node with work
        pkt = None
        src = None
        for node in nodes:
            sched = scheds.get(node.name)
            if sched is None or node.name in finished:
                continue
            c0 = sched.stats.lock_crossings
            pkt = sched.acquire(i) if leased else sched.next_packet(i)
            crossings = sched.stats.lock_crossings - c0
            if pkt is not None:
                src = node
                break
        if pkt is None:
            idle.append(i)                 # re-woken on node activation
            free[i] = t
            continue
        if crossings:
            start = max(t, host_free)
            host_free = start + crossings * hand_off
        else:
            start = t
        dt = d.packet_cost(pkt.offset, pkt.size, src.total_work, start,
                           policy, first[i])[0] + (start - t)
        first[i] = False
        if d.jitter > 0:
            dt *= math.exp(rng.gauss(0.0, d.jitter))
        end = t + dt
        busy[i] += dt
        free[i] = end
        sched = scheds[src.name]
        max_end[src.name] = max(max_end[src.name], end)
        sched.note_packet_latency(i, dt)
        if hasattr(sched, "observe"):
            sched.observe(i, pkt.size / max(dt, 1e-12))
        sched.release(i)
        if sched.remaining() == 0 and src.name not in finished:
            # every packet of this node has been carved AND resolved (each
            # acquire resolves its end time immediately), so the node's
            # finish is the latest packet end — not this packet's
            fin = max_end[src.name]
            finished[src.name] = fin
            if activate(fin):
                # newly-ready nodes: wake every parked device
                for j in idle:
                    heapq.heappush(heap, (max(fin, free[j]), j))
                idle = []
        heapq.heappush(heap, (end, i))

    if len(finished) != len(nodes):
        raise RuntimeError(
            "graph stalled: "
            f"{sorted(set(n.name for n in nodes) - set(finished))} "
            "never became ready (cycle or lost wakeup)")
    return DagSimResult(makespan=max(finished.values(), default=0.0),
                        node_finish=dict(finished),
                        node_start=dict(started),
                        device_busy=busy, depth=depth)


# ---------------------------------------------------------------------------
# Multi-tenant simulation: the FleetArbiter's discrete-event twin.
# ---------------------------------------------------------------------------

@dataclass
class SimTenant:
    """One tenant of a simulated shared fleet: a work range plus the
    arbitration policy knobs of ``repro.tenancy.TenantConfig``.
    ``arrival`` delays activation (an exclusive tenant arriving mid-stream
    is the takeover-latency experiment)."""
    name: str
    total_work: int
    lws: int = 1
    weight: float = 1.0
    priority: int = 0
    exclusive: bool = False
    arrival: float = 0.0
    scheduler: Optional[str] = None        # per-tenant override of cfg's


@dataclass
class TenantSimResult:
    makespan: float
    tenant_finish: Dict[str, float]
    tenant_wg: Dict[str, int]              # executed work per tenant
    shares: Dict[str, float]               # tenant_wg normalized
    windows: List[Tuple[str, int, float, float, int]]
    #   (tenant, device, start, end, wg) — the isolation audit record
    preemptions: int
    takeover_latency: Dict[str, float]     # exclusive: first grant - arrival
    device_busy: List[float]


def simulate_multitenant(tenants: Sequence[SimTenant],
                         devices: Sequence[SimDevice],
                         cfg: SimConfig) -> TenantSimResult:
    """Discrete-event execution of N tenants sharing one device fleet.

    The threaded twin is ``FleetArbiter`` + N tenant ``EngineSession``s:
    one scheduler instance per tenant (exactly one ``_RunContext`` each),
    and every device event runs the arbiter's election — exclusive fence
    head first, then the highest priority class with work, then lowest
    weighted virtual time (``vt += wg / weight`` per packet).  Grants
    flip only at packet boundaries (a device event IS one), and an
    exclusive tenant's first packet gates on every co-tenant's in-flight
    packet end — zero overlap by construction, recorded in ``windows``
    so tests can verify rather than assume it.  Devices keep
    ``simulate()``'s cost model (irregularity, jitter, ``fail_at``
    requeue + mark_dead fault tolerance).
    """
    import random
    rng = random.Random(cfg.seed)
    policy = cfg.policy
    leased = cfg.dispatch == "leased"
    hand_off = cfg.hand_off_cost
    n = len(devices)
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError("duplicate tenant names")
    profiles = [DeviceProfile(d.name, d.throughput * d.profile_bias,
                              power_model=d.power_model)
                for d in devices]
    scheds: Dict[str, object] = {}
    for ten in tenants:
        s = make_scheduler(ten.scheduler or cfg.scheduler, ten.total_work,
                           ten.lws, profiles, **cfg.scheduler_kwargs)
        cfg.tune_scheduler(s)
        scheds[ten.name] = s
    vt = {t.name: 0.0 for t in tenants}
    usage = {t.name: 0 for t in tenants}
    windows: List[Tuple[str, int, float, float, int]] = []
    takeover: Dict[str, float] = {}
    preempt = 0
    grant: List[Optional[str]] = [None] * n
    cur_tenant: List[Optional[str]] = [None] * n   # packet in flight
    cur_end = [0.0] * n
    busy = [0.0] * n
    dead = [False] * n
    first = [True] * n
    heap: List[Tuple[float, int]] = [(0.0, i) for i in range(n)]
    heapq.heapify(heap)
    idle: List[int] = []
    host_free = 0.0
    arrivals = sorted({t.arrival for t in tenants})

    def has_work(name: str) -> bool:
        return scheds[name].remaining() > 0

    def elect_order(now: float) -> List[SimTenant]:
        """Candidates in grant order — the arbiter's _elect_locked rule.
        An active exclusive tenant starves everyone else (the fence)."""
        ex = [t for t in tenants
              if t.exclusive and t.arrival <= now and has_work(t.name)]
        if ex:
            return [min(ex, key=lambda t: (t.arrival, t.name))]
        cands = [t for t in tenants if t.arrival <= now and has_work(t.name)]
        return sorted(cands, key=lambda t: (-t.priority, vt[t.name], t.name))

    def wake_idle(at: float) -> None:
        nonlocal idle
        for j in idle:
            if not dead[j]:
                heapq.heappush(heap, (at, j))
        idle = []

    while heap:
        t0, i = heapq.heappop(heap)
        if dead[i]:
            continue
        d = devices[i]
        cur_tenant[i] = None               # this device's packet has ended
        pkt = None
        src: Optional[SimTenant] = None
        crossings = 0
        for cand in elect_order(t0):
            sched = scheds[cand.name]
            c0 = sched.stats.lock_crossings
            p = sched.acquire(i) if leased else sched.next_packet(i)
            crossings = sched.stats.lock_crossings - c0
            if p is not None:
                pkt, src = p, cand
                break
        if pkt is None:
            nxt = [a for a in arrivals if a > t0]
            if nxt:                        # sleep until the next activation
                heapq.heappush(heap, (nxt[0], i))
            else:
                idle.append(i)             # re-woken on packet completion
            continue
        start = t0
        if src.exclusive:
            # the fence: no exclusive packet may start while a co-tenant
            # packet is in flight anywhere (the arbiter's _begin_run wait)
            start = max([start] + [cur_end[j] for j in range(n)
                                   if cur_tenant[j] is not None
                                   and cur_tenant[j] != src.name])
        if crossings:
            s2 = max(start, host_free)
            host_free = s2 + crossings * hand_off
            start = s2
        if src.exclusive and src.name not in takeover:
            takeover[src.name] = start - src.arrival
        if grant[i] is not None and grant[i] != src.name \
                and has_work(grant[i]):
            preempt += 1                   # took the device from live work
        grant[i] = src.name
        cost = d.packet_cost(pkt.offset, pkt.size, src.total_work, start,
                             policy, first[i])
        first[i] = False
        dt = cost.t + (start - t0)
        if d.jitter > 0:
            dt *= math.exp(rng.gauss(0.0, d.jitter))
        end = t0 + dt
        if d.fail_at is not None and end > d.fail_at >= t0:
            dead[i] = True
            sched.requeue(pkt)
            sched.release(i)
            sched.mark_dead(i)
            wake_idle(d.fail_at)
            for j in range(n):             # survivors absorb the requeue
                if not dead[j] and j != i:
                    heapq.heappush(heap, (max(d.fail_at, cur_end[j]), j))
            continue
        vt[src.name] += pkt.size / src.weight
        usage[src.name] += pkt.size
        busy[i] += dt
        cur_tenant[i] = src.name
        cur_end[i] = end
        windows.append((src.name, i, start, end, pkt.size))
        sched.note_packet_latency(i, dt)
        if hasattr(sched, "observe"):
            sched.observe(i, pkt.size / max(dt, 1e-12))
        sched.release(i)
        heapq.heappush(heap, (end, i))
        wake_idle(end)                     # completions re-open elections

    for ten in tenants:
        if scheds[ten.name].remaining() > 0:
            raise RuntimeError(
                f"tenant {ten.name!r}: all devices failed with work left")
    tenant_end = {t.name: 0.0 for t in tenants}
    for name, _dev, _s, e, _wg in windows:
        tenant_end[name] = max(tenant_end[name], e)
    total = sum(usage.values())
    shares = {k: (v / total if total else 0.0) for k, v in usage.items()}
    return TenantSimResult(
        makespan=max(tenant_end.values(), default=0.0),
        tenant_finish=tenant_end, tenant_wg=dict(usage), shares=shares,
        windows=windows, preemptions=preempt, takeover_latency=takeover,
        device_busy=busy)


# ---------------------------------------------------------------------------
# Open-loop serving: the CoexecServer's discrete-event twin.
# ---------------------------------------------------------------------------

@dataclass
class ServeSimState:
    """Carry-over state for incremental serving simulation (the fleet
    router's co-simulation hook).

    A fleet-level router places requests epoch by epoch and needs each
    replica's ``simulate_serving`` to *resume* — device clocks, online
    power estimates, the pipeline fill and the jitter stream must carry
    across calls, or chunked execution would diverge from a one-shot run.
    Obtain one from ``ServeSimResult.state`` and pass it back via
    ``simulate_serving(..., resume=state)``.  ``residual_wg(now)`` is the
    measured outstanding work the router's EWMA tracks.
    """
    free: List[float]                      # per-device clock (busy until)
    busy: List[float]                      # cumulative busy time
    swait: List[float]                     # cumulative modeled sched wait
    dead: List[bool]
    first_pkt: List[bool]                  # pipeline fill paid?
    powers: List[float]                    # online EWMA power estimates
    now: float = 0.0
    rounds: int = 0
    rng: Optional[object] = None           # jitter stream (random.Random)
    # cumulative energy accounting (empty lists == zero-initialized; kept
    # defaulted so pre-energy constructors keep working)
    cbusy: List[float] = field(default_factory=list)   # executing seconds
    crossings: List[int] = field(default_factory=list)
    bytes_moved: List[float] = field(default_factory=list)

    def residual_wg(self, now: float) -> float:
        """In-flight work (wg) still queued on surviving device clocks."""
        return sum(max(f - now, 0.0) * p
                   for f, p, d in zip(self.free, self.powers, self.dead)
                   if not d)

    def alive_power(self) -> float:
        return sum(p for p, d in zip(self.powers, self.dead) if not d)


@dataclass
class ServeSimResult:
    requests: List                         # input requests, accounting filled
    duration: float                        # last completion / shed time
    device_busy: List[float]
    rounds: int
    all_dead: bool = False                 # every device failed mid-stream
    # per-device modeled scheduler hand-off wait, summed across rounds
    sched_wait: List[float] = field(default_factory=list)
    # carry-over hook: pass back as resume= to continue this fleet's
    # timeline with more requests (fleet co-simulation)
    state: Optional[ServeSimState] = None
    # joule accounting over the (cumulative, if resumed) timeline; None
    # never happens from simulate_serving itself — kept Optional for
    # hand-built results in tests
    energy: Optional[EnergyReport] = None

    @property
    def energy_j(self) -> float:
        """Total joules (0.0 for joule-blind power models)."""
        return self.energy.total_j if self.energy is not None else 0.0


def simulate_serving(requests: Sequence, lws: int,
                     devices: Sequence[SimDevice], cfg: SimConfig, *,
                     policy: str = "shed",
                     batch_window_s: float = 0.0,
                     round_quantum_s: float = math.inf,
                     admission=None,
                     resume: Optional[ServeSimState] = None
                     ) -> ServeSimResult:
    """Open-loop serving against calibrated device models.

    ``requests`` are ``repro.serve.workload.Request``-shaped objects (duck
    typed: rid/arrival/deadline/size read; finish/shed/replica written), kept
    out of this module so core never imports the serve layer.  Semantics
    mirror CoexecServer: successive *dispatch rounds* of EDF-ordered
    admission, one scheduler instance per round (same SCHEDULERS registry,
    same observe/requeue API as ``simulate``), predictions and shedding from
    the cross-round EWMA powers.  Devices keep simulate()'s failure /
    straggler / jitter / transfer model, so the same serving policies can be
    stress-tested at 1000-replica scale in milliseconds.

    Router-policy hooks (the fleet subsystem's attachment points):

    * ``admission`` — an injected policy object with the
      ``EdfAdmission.admit`` contract (serve/admission.py).  When given it
      replaces the inline EDF + quantum + shed procedure, so the threaded
      server, the fleet router and this simulator run the *same* decision
      code.  With the matching config the hook path is bit-identical to
      the inline one (locked by tests/test_admission.py).
    * ``resume`` — a :class:`ServeSimState` from a previous call: device
      clocks, EWMA powers, pipeline fill and jitter stream continue, so a
      fleet router can feed a replica its routed requests epoch by epoch.
      The returned ``busy``/``sched_wait``/``rounds`` are then cumulative
      over the resumed timeline.
    """
    import random
    assert policy in ("shed", "none")
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    n = len(devices)
    policy_name = cfg.policy
    leased = cfg.dispatch == "leased"
    hand_off = cfg.hand_off_cost
    if resume is not None:
        if len(resume.free) != n:
            raise ValueError(f"resume state has {len(resume.free)} devices, "
                             f"got {n}")
        st = resume
        rng = st.rng if st.rng is not None else random.Random(cfg.seed)
    else:
        st = ServeSimState(
            free=[0.0] * n, busy=[0.0] * n, swait=[0.0] * n,
            dead=[False] * n, first_pkt=[True] * n,
            # cross-round power estimates: start from the (possibly
            # biased) offline profile; rounds with an observing scheduler
            # refine them online
            powers=[d.throughput * d.profile_bias for d in devices])
        rng = random.Random(cfg.seed)
    st.rng = rng
    # zero-init the energy accumulators (resume states built before the
    # energy fields existed arrive with empty lists)
    if len(st.cbusy) != n:
        st.cbusy = [0.0] * n
    if len(st.crossings) != n:
        st.crossings = [0] * n
    if len(st.bytes_moved) != n:
        st.bytes_moved = [0.0] * n
    swait = st.swait
    powers = st.powers
    free = st.free
    busy = st.busy
    dead = st.dead
    # pipeline fill: with pooled buffers the arena persists across rounds,
    # so a device pays the stage-in fill once per serve, not once per round
    first_pkt = st.first_pkt
    now = st.now
    i_next = 0
    pending: List = []
    rounds = st.rounds
    all_dead = False

    def alive() -> List[int]:
        return [i for i in range(n) if not dead[i]]

    while pending or i_next < len(reqs):
        if not alive():
            all_dead = True
            for r in pending + reqs[i_next:]:
                r.shed = True
            break
        # release arrivals; when idle, jump the clock to the next arrival
        # plus the batching window (standard serving micro-batching: a few
        # ms of waiting gives the round enough work for a proportional
        # split to be meaningful and amortizes per-packet overheads)
        if not pending and i_next < len(reqs):
            now = max(now, reqs[i_next].arrival + batch_window_s)
        while i_next < len(reqs) and reqs[i_next].arrival <= now:
            pending.append(reqs[i_next])
            i_next += 1
        # admission: EDF order, shed predicted misses (CoexecServer._admit).
        # Predictions start from the earliest time any replica frees up, so
        # an in-flight backlog pushes predicted finishes (and sheds) out.
        pending.sort(key=lambda r: (r.deadline, r.rid))
        total_p = sum(powers[i] for i in alive())
        # residual in-flight work (wg) already queued on device clocks:
        # without it the predictor only sees THIS round's queue and admits
        # doomed requests under backlog
        resid = sum(max(free[i] - now, 0.0) * powers[i] for i in alive())
        if admission is not None:
            # injected policy object (serve/admission.py): the exact
            # decision procedure the threaded server and the fleet router
            # run — bit-identical to the inline path below with the
            # matching config (tests/test_admission.py locks it)
            admitted, pending = admission.admit(
                pending, now, total_power=total_p, residual_wg=resid,
                calibrated=True)
        else:
            # round quantum (iteration-level scheduling): admit only ~one
            # quantum of EDF-first work per round, so under backlog the
            # server re-sorts, re-predicts and re-sheds frequently instead
            # of committing the whole queue to one long round
            cap_wg = total_p * round_quantum_s
            admitted = []
            leftover: List = []
            cum = 0.0
            for r in pending:
                if admitted and cum + r.size > cap_wg:
                    leftover.append(r)
                    continue
                cum += r.size
                if (policy == "shed"
                        and now + (resid + cum) / total_p > r.deadline):
                    r.shed = True
                    cum -= r.size
                else:
                    admitted.append(r)
            pending = leftover
        if not admitted:
            continue
        rounds += 1
        # one scheduler instance over the admitted round
        amap = alive()
        G = sum(r.size for r in admitted)
        wg_owner: List[int] = []           # work-group offset -> request idx
        for j, r in enumerate(admitted):
            wg_owner.extend([j] * r.size)
        profiles = [DeviceProfile(devices[g].name, powers[g],
                                  power_model=devices[g].power_model)
                    for g in amap]
        skw = dict(cfg.scheduler_kwargs)
        order = rotate_static_order(cfg.scheduler, len(amap), rounds)
        if order is not None:
            skw.setdefault("order", order)
        sched = make_scheduler(cfg.scheduler, G, lws, profiles, **skw)
        cfg.tune_scheduler(sched)
        if hasattr(sched, "update_slack"):
            sched.update_slack(min(r.deadline for r in admitted) - now)
        done_wg = [0] * len(admitted)
        fin_max = [0.0] * len(admitted)
        heap: List[Tuple[float, int]] = []
        for ai, g in enumerate(amap):
            heapq.heappush(heap, (max(now, free[g]), ai))
        # host-thread serialization is round-local: rounds overlap in wall
        # time but are processed sequentially, so carrying the chain across
        # rounds would let a straggler's late launch block earlier ones
        host_free = now
        while heap:
            t, ai = heapq.heappop(heap)
            g = amap[ai]
            d = devices[g]
            if dead[g]:
                continue
            if t < free[g]:
                # stale entry (failure wakeups push duplicates for devices
                # that already have a live event): a device can't start a
                # packet before its clock frees up
                heapq.heappush(heap, (free[g], ai))
                continue
            c0 = sched.stats.lock_crossings
            pkt = sched.acquire(ai) if leased else sched.next_packet(ai)
            crossings = sched.stats.lock_crossings - c0
            if pkt is None:
                continue
            # host serialization only on actual lock crossings (leased
            # dispatch amortizes them; local lease pops are free)
            if crossings:
                start = max(t, host_free)
                host_free = start + crossings * hand_off
            else:
                start = t
            swait[g] += start - t
            was_first = first_pkt[g]
            cost = d.packet_cost(pkt.offset, pkt.size, G, start, policy_name,
                                 first_pkt[g])
            first_pkt[g] = False
            raw_dt = cost.t + (start - t)
            dt = raw_dt
            if d.jitter > 0:
                dt *= math.exp(rng.gauss(0.0, d.jitter))
            end = t + dt
            # unlike the fixed-batch simulate(), a serving device can be
            # idle when its failure time passes — it is dead for any packet
            # starting at or after fail_at, not just one spanning it
            if d.fail_at is not None and (t >= d.fail_at
                                          or end > d.fail_at >= t):
                dead[g] = True
                free[g] = min(t, d.fail_at)
                sched.requeue(pkt)
                sched.release(ai)
                # reclaim the dead device's leased-but-unexecuted packets
                # AND any pre-assigned unclaimed chunk (Static*) so the
                # survivors can absorb them this round — same contract as
                # simulate() and the threaded engine's device loops
                sched.mark_dead(ai)
                for aj, gj in enumerate(amap):
                    if not dead[gj]:
                        heapq.heappush(heap, (max(d.fail_at, free[gj]), aj))
                continue
            busy[g] += dt
            free[g] = end
            st.cbusy[g] += cost.busy_s * (dt / raw_dt if raw_dt > 0 else 1.0)
            st.bytes_moved[g] += d.packet_bytes(pkt.size, policy_name,
                                                was_first)
            sched.note_packet_latency(ai, dt)
            if hasattr(sched, "observe"):
                sched.observe(ai, pkt.size / max(dt, 1e-12))
            sched.release(ai)
            for o in range(pkt.offset, pkt.offset + pkt.size):
                j = wg_owner[o]
                done_wg[j] += 1
                fin_max[j] = max(fin_max[j], end)
                if done_wg[j] == admitted[j].size:
                    admitted[j].finish = fin_max[j]
                    admitted[j].replica = d.name
            heapq.heappush(heap, (end, ai))
        if sched.remaining() > 0:
            # every device died mid-round (amap was the full alive set):
            # unfinished requests are lost, and the fleet is gone even if
            # the loop exits before re-checking alive()
            all_dead = True
            for j, r in enumerate(admitted):
                if done_wg[j] < r.size:
                    r.shed = True
        # energy: fold the round scheduler's per-device lock-crossing
        # counters into the cumulative state (it indexes the round's
        # alive map)
        rc = sched.lock_crossings_by_device()
        for ai, g in enumerate(amap):
            st.crossings[g] += rc[ai]
        # carry the schedulers' online estimates into the next round's
        # profile (schedulers without observe leave them untouched — Static
        # keeps trusting its offline profile, and keeps paying for it)
        for ai, g in enumerate(amap):
            if not dead[g] and hasattr(sched, "observe"):
                powers[g] = sched.devices[ai].power
        # next round: earliest point a surviving device frees up, but never
        # before the next arrival if the fleet drained the backlog
        if i_next < len(reqs) or pending:
            nxt = min(free[g] for g in alive()) if alive() else now
            now = max(now, nxt)

    st.now = now
    st.rounds = rounds
    fins = [r.finish for r in reqs if r.finish is not None]
    duration = max(fins) if fins else now
    # energy: every device is powered for the whole serving window (idle
    # watts bridge the arrival gaps); a dead device only until it failed.
    # Cumulative over a resumed timeline, like busy/sched_wait.
    end_t = max([duration, now]
                + [f for f, dd in zip(free, dead) if not dd])
    meter = EnergyMeter()
    for g, d in enumerate(devices):
        window = min(end_t, d.fail_at) if (dead[g] and d.fail_at is not None) \
            else end_t
        meter.add(d.name, d.power_model,
                  busy_s=min(st.cbusy[g], window), window_s=window,
                  crossings=st.crossings[g], bytes_moved=st.bytes_moved[g])
    return ServeSimResult(requests=reqs, duration=duration,
                          device_busy=list(busy), rounds=rounds,
                          all_dead=all_dead, sched_wait=list(swait),
                          state=st, energy=meter.report())
