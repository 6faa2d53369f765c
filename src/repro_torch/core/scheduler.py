"""Load-balancing schedulers (the paper's §II-B, faithful formulas).

Work model: a data-parallel task described by a
:class:`repro_torch.core.region.Region` — a 1-D or 2-D NDRange with
per-dimension offset/size/lws.  The carved axis is dim 0 (the paper's
NDRange work-groups; here: image rows,
pixel blocks, options, bodies, microbatches, requests).  Packets are
contiguous ``[offset, offset+size)`` runs of dim-0 units, ``lws``-aligned
except for the final remainder; 2-D regions are carved as **row panels**
(each packet spans the full dim-1 extent), and every packet carries its
absolute geometry as ``Packet.region``.  A bare ``total_work`` integer is
still accepted everywhere and means the legacy 1-D region at offset 0.

* ``Static``      — one packet per device, sized proportionally to its
                    computing power; delivery order configurable
                    (``Static`` = CPU,iGPU,GPU / ``Static rev`` = reversed).
* ``Dynamic(n)``  — n equal packets pulled from an atomic queue.
* ``HGuided``     — the paper's heterogeneity-aware guided self-scheduling:

      packet_size_i = max( m_i * lws,
                           ceil( G_r * P_i / (k_i * n * sum_j P_j) ) )

  with G_r = remaining work-groups (updated per launch), k_i in [1, 4],
  m_i the minimum-packet multiplier of lws.
* ``HGuidedOpt``  — the paper's optimized HGuided: the (m_i, k_i) pairs are
  derived from the device power *ranking* per the paper's tuning laws
  (more powerful => larger m, smaller k; best combo m={1,15,30},
  k={3.5,1.5,1} for a weak/mid/strong triple), plus optional online EWMA
  power re-estimation (beyond-paper, used by the hetero-DP trainer).
* ``HGuidedDeadline`` — beyond-paper serving variant of HGuidedOpt: packet
  sizes are additionally capped by the tightest remaining deadline slack
  (``update_slack``), shrinking toward ``lws`` as deadlines close in.

* ``HGuidedEnergy`` — beyond-paper energy-capped variant: the deadline
  scheduler's cap shape applied to joules — packets are carved so the
  run's *predicted* energy (from the profiles'
  :class:`repro_torch.energy.model.PowerModel`) stays under a per-run
  ``energy_budget_j``, degrading toward the most-efficient device when
  the budget binds.

* ``HGuidedSteal``   — beyond-paper "new load balancing algorithm": a
  deadline-capable HGuided that dispatches through *leased packet plans*
  (see below) and lets an idle device steal half the largest victim lease
  before falling back to the global carve, so the run tail stays balanced
  without per-packet lock traffic.

All schedulers are thread-safe (the paper's "atomic queue") and support
``requeue`` of in-flight packets for fault tolerance.

Dispatch hot path — leases vs per-packet locking
------------------------------------------------

``next_packet`` is the paper's hand-off: one global lock acquisition per
packet.  On an oversubscribed host every contended acquisition costs a
thread wake (~200µs on the 2-core reference container) — for small tail
packets that overhead rivals the compute itself.  The lease API amortizes
it:

* ``lease(device, k)`` carves up to ``k`` packets under ONE lock
  acquisition into a per-device :class:`PacketLease` (a local deque owned
  by the device thread; pops touch only the lease's own uncontended
  lock).  ``k`` adapts per device: it starts at 1 and grows
  geometrically while the device's observed packet latency (fed via
  ``note_packet_latency``) is small against ``lease_overhead_s``, and
  every lease is capped to half the device's fair share of the remaining
  work so the tail stays balanced as ``remaining()`` falls.
* ``acquire(device)`` is the device thread's hot path: pop the local
  lease; when empty, refill via the scheduler's ``_refill`` hook
  (``HGuidedSteal``: steal half the largest victim lease first, then the
  global carve; everything else: global carve).
* ``release(device)`` must be called once per acquired packet (after its
  commit, or after its ``requeue``) — together with ``drained()`` this
  gives engines a lock-free exactly-once drain test: work is continuously
  visible in ``remaining() + outstanding`` from carve to commit, and a
  retry epoch counter invalidates the check if a requeue raced it.
* leased-but-unexecuted packets still count as outstanding work:
  ``remaining()`` includes lease contents, and ``mark_dead`` drains a
  dead device's lease back into the retry queue (FIFO, oldest first) so
  the exact-cover invariant survives steals, leases and deaths.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import math
import threading
import time
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, Iterable, List, Mapping,
                    Optional, Sequence, Tuple, Union)

from repro_torch.core.region import Region, as_region
from repro_torch.energy.model import PowerModel


@dataclass(frozen=True)
class Packet:
    # offset/size are dim-0 units RELATIVE to the scheduled region's start
    # (so coverage invariants read [0, G) regardless of the ROI's origin);
    # ``region`` is the packet's ABSOLUTE geometry — the row panel the
    # executor runs
    offset: int
    size: int
    seq: int
    device: int
    # fault-tolerance provenance: a requeued packet keeps its original seq
    # and is re-issued with retried=True, so RunResult.packets never reports
    # more sequence numbers than packets actually carved
    retried: bool = False
    region: Optional[Region] = None


@dataclass
class DeviceProfile:
    name: str
    power: float                 # computing power P_i (work-groups / s)
    min_mult: int = 1            # m_i: min packet = m_i * lws
    k: float = 2.0               # k_i decay constant
    # energy model of the device behind this profile (None = joule-blind):
    # the energy-capped scheduler ranks devices by busy_w / power (J/wg)
    power_model: Optional[PowerModel] = None


@dataclass
class SchedStats:
    """Dispatch-path counters (exact in single-threaded use, e.g. the
    simulator; best-effort under threads, where they are only read for
    reporting)."""
    lock_crossings: int = 0      # global-lock acquisitions on the hot path
    next_packets: int = 0        # per-packet-lock hand-offs
    leases: int = 0              # lease refills granted
    leased_packets: int = 0      # packets handed out through leases
    local_pops: int = 0          # packets popped from a local lease
    steals: int = 0              # successful steal operations
    stolen_packets: int = 0      # packets moved by steals
    reclaims: int = 0            # leases drained back by preemption
    reclaimed_packets: int = 0   # packets returned by reclaim_lease

    def merge(self, other: "SchedStats") -> "SchedStats":
        """Accumulate ``other`` into this instance (per-tenant rollup:
        one run's scheduler dies with its _RunContext, so a tenant's
        cross-run dispatch accounting sums the per-run counters here).
        Returns self for chaining."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


class PacketLease:
    """A device-local run of leased packets.

    The owning device thread pops from the front; a thief takes the back
    half.  All mutation is under the lease's own lock — uncontended on
    the hot path (only steals and the owner ever touch it), so a pop
    costs a few hundred nanoseconds instead of a contended global-lock
    hand-off."""

    __slots__ = ("device", "_dq", "_lock")

    def __init__(self, device: int):
        self.device = device
        self._dq: Deque[Packet] = collections.deque()
        self._lock = threading.Lock()

    def popleft(self) -> Optional[Packet]:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def extend(self, pkts: Iterable[Packet]) -> None:
        with self._lock:
            self._dq.extend(pkts)

    def steal_half(self) -> List[Packet]:
        """Remove and return the back half (newest-first order; empty if
        the lease holds fewer than two packets — the owner always keeps
        at least one)."""
        with self._lock:
            n = len(self._dq) // 2
            return [self._dq.pop() for _ in range(n)]

    def drain(self) -> List[Packet]:
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
            return out

    def __len__(self) -> int:
        return len(self._dq)

    @property
    def work(self) -> int:
        """Total leased work-groups (locked: exact)."""
        with self._lock:
            return sum(p.size for p in self._dq)


class SchedulerBase:
    # lease tuning (class attrs so plugins/tests can override): one global
    # lock crossing is worth ~a contended thread wake on the reference
    # container; leases grow until that cost is ≤ lease_overhead_frac of
    # the lease's compute time (2%: over-leasing is cheap — the tail
    # budget bounds it and steals rebalance it), never past lease_k_max
    lease_overhead_s: float = 2e-4
    lease_overhead_frac: float = 0.02
    lease_k_max: int = 64
    def __init__(self, total_work: Union[int, Region], lws: int,
                 devices: Sequence[DeviceProfile]):
        """``total_work`` is a Region (NDRange) or a bare work-group count
        (legacy 1-D).  With a Region, the carved axis is dim 0 and ``lws``
        is taken from ``region.dims[0].lws`` (the argument is ignored)."""
        self.region = as_region(total_work, lws)
        self.G = self.region.dims[0].size
        self.lws = self.region.dims[0].lws
        assert self.G > 0 and self.lws > 0
        self.devices = list(devices)
        self._lock = threading.Lock()
        self._offset = 0
        self._seq = 0
        # retry pool: FIFO (oldest requeued packet re-issues first), so a
        # straggler's early packet cannot be starved behind later requeues
        self._retry: Deque[Packet] = collections.deque()
        n = len(self.devices)
        self._leases: List[PacketLease] = [PacketLease(i) for i in range(n)]
        self._lease_k: List[int] = [1] * n        # adaptive lease size
        self._lease_lat: List[Optional[float]] = [None] * n
        self._outstanding: List[int] = [0] * n    # acquired, not released
        self._wait_s: List[float] = [0.0] * n     # time in dispatch calls
        self._crossings: List[int] = [0] * n      # per-device lock crossings
        self._dead: set = set()                   # devices seen by mark_dead
        self._retry_epoch = 0                     # bumped on every requeue
        self.stats = SchedStats()

    # -- public ------------------------------------------------------------
    def set_lease_params(self, *, lease_overhead_s: Optional[float] = None,
                         lease_overhead_frac: Optional[float] = None,
                         lease_k_max: Optional[int] = None) -> "SchedulerBase":
        """Override the lease growth-law constants on THIS instance.

        The class-attribute defaults above are hand-picked for the
        reference container; sessions (``tuned=`` / lease kwargs) and the
        simulators inject calibrated values here instead of editing the
        module.  ``None`` leaves a constant untouched.  Returns ``self``
        so construction sites can chain."""
        if lease_overhead_s is not None:
            if lease_overhead_s <= 0:
                raise ValueError(f"lease_overhead_s must be > 0, "
                                 f"got {lease_overhead_s}")
            self.lease_overhead_s = float(lease_overhead_s)
        if lease_overhead_frac is not None:
            if not 0 < lease_overhead_frac <= 1:
                raise ValueError(f"lease_overhead_frac must be in (0, 1], "
                                 f"got {lease_overhead_frac}")
            self.lease_overhead_frac = float(lease_overhead_frac)
        if lease_k_max is not None:
            if int(lease_k_max) < 1:
                raise ValueError(f"lease_k_max must be >= 1, "
                                 f"got {lease_k_max}")
            self.lease_k_max = int(lease_k_max)
        return self

    def next_packet(self, device: int) -> Optional[Packet]:
        """Per-packet hand-off: ONE global lock acquisition per packet
        (the paper's atomic queue; the baseline the lease API beats)."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                self.stats.lock_crossings += 1
                self._crossings[device] += 1
                self.stats.next_packets += 1
                self._outstanding[device] += 1
                pkt = self._pop_retry_locked(device)
                if pkt is None:
                    pkt = self._carve(device)
                if pkt is None:
                    self._outstanding[device] -= 1
                return pkt
        finally:
            self._wait_s[device] += time.perf_counter() - t0

    def acquire(self, device: int) -> Optional[Packet]:
        """Leased hot path: pop the device's local lease (uncontended);
        when empty, refill through ``_refill`` (one global crossing for a
        whole packet plan).  Pair every non-None return with one
        ``release(device)`` call after the packet commits or requeues."""
        while True:
            pkt = self._pop_local(device)
            if pkt is not None:
                return pkt
            if not self._refill(device):
                return None

    def release(self, device: int) -> None:
        """Account a previously acquired packet as done (committed or
        requeued).  Owner-thread only; pairs with next_packet/acquire."""
        self._outstanding[device] -= 1

    def lease(self, device: int, k: Optional[int] = None) -> int:
        """Refill ``device``'s local lease under ONE lock acquisition.

        Drains the retry pool FIFO first, then carves fresh packets, up
        to ``k`` packets (``None`` = adaptive) — but never more work than
        half the device's fair share of what remains, so leases shrink
        with the tail.  Returns the number of packets leased."""
        t0 = time.perf_counter()
        granted: List[Packet] = []
        try:
            with self._lock:
                self.stats.lock_crossings += 1
                self._crossings[device] += 1
                if k is None:
                    k = self._adaptive_k_locked(device)
                k = max(1, int(k))
                # tail budget: never lease more than HALF the device's
                # power-proportional fair share of remaining() (uncarved
                # pool + retries + work already leased anywhere) — a
                # slow device must not hoard packets the fast ones will
                # be idle for (steals recover the rest, where available)
                left = self._remaining_locked()
                d = self.devices[device]
                total_p = sum(x.power for x in self.devices) or 1.0
                budget = max(self.lws,
                             int(left * d.power / (2.0 * total_p)))
                work = 0
                while len(granted) < k and work < budget:
                    pkt = self._pop_retry_locked(device)
                    if pkt is None:
                        pkt = self._carve(device)
                    if pkt is None:
                        break
                    granted.append(pkt)
                    work += pkt.size
                if granted:
                    self.stats.leases += 1
                    self.stats.leased_packets += len(granted)
                    self._leases[device].extend(granted)
            return len(granted)
        finally:
            self._wait_s[device] += time.perf_counter() - t0

    def steal(self, thief: int) -> int:
        """Move the back half of the largest victim lease onto ``thief``'s
        lease (packets re-stamped to the thief, provenance preserved).
        Returns the number of packets stolen.  Available on every
        scheduler; ``HGuidedSteal`` wires it into its refill path."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                self.stats.lock_crossings += 1
                self._crossings[thief] += 1
                victim = None
                best = 0
                for i, lease in enumerate(self._leases):
                    if i == thief:
                        continue
                    w = lease.work
                    if w > best:
                        best, victim = w, lease
                if victim is None:
                    return 0
                stolen = victim.steal_half()
                if not stolen:
                    return 0
                stolen.reverse()          # back half, restored to FIFO order
                self._leases[thief].extend(
                    dataclasses.replace(p, device=thief) for p in stolen)
                self.stats.steals += 1
                self.stats.stolen_packets += len(stolen)
                return len(stolen)
        finally:
            self._wait_s[thief] += time.perf_counter() - t0

    def note_packet_latency(self, device: int, seconds: float) -> None:
        """Feed the device's observed per-packet wall latency — this is
        what grows/shrinks its adaptive lease size.  Owner-thread only."""
        if seconds > 0:
            prev = self._lease_lat[device]
            self._lease_lat[device] = seconds if prev is None \
                else 0.5 * seconds + 0.5 * prev

    def requeue(self, pkt: Packet) -> None:
        """Return an in-flight packet to the queue (device failure)."""
        with self._lock:
            self._requeue_locked(pkt)

    def reclaim_lease(self, device: int) -> int:
        """Return ``device``'s leased-but-unexecuted packets to the retry
        pool WITHOUT marking the device dead (the multi-tenant preemption
        hook: a device denied at the grant boundary must not strand its
        planned packets — any still-granted device of the same run picks
        them up from the retry queue).  The device stays eligible for
        future leases; in-flight (acquired) packets are untouched, so the
        exact-cover and ``drained()`` protocols hold across preemptions.
        Returns the number of packets reclaimed."""
        with self._lock:
            pkts = self._leases[device].drain()
            for pkt in pkts:
                self._requeue_locked(pkt)
            if pkts:
                self.stats.reclaims += 1
                self.stats.reclaimed_packets += len(pkts)
            return len(pkts)

    def mark_dead(self, device: int) -> None:
        """Notify that a device died: its leased-but-unexecuted packets
        re-enter the retry pool (preserving the exact-cover invariant),
        and pre-assignment schedulers additionally release the dead
        device's unclaimed chunk via ``_release_dead_locked`` — otherwise
        that work is stranded and the run can never drain."""
        with self._lock:
            self._dead.add(device)
            for pkt in self._leases[device].drain():
                self._requeue_locked(pkt)
            self._release_dead_locked(device)

    def remaining(self) -> int:
        """Outstanding work-groups still owned by the scheduler: uncarved
        pool + retry queue + leased-but-unexecuted packets.  (Leases
        count: serving admission and deadline slack caps must see work a
        device has planned but not run.)"""
        with self._lock:
            return self._remaining_locked()

    def _remaining_locked(self) -> int:
        """remaining() under the held lock — subclasses with different
        pool accounting (Static*) override this ONE place; lease()'s
        tail budget uses it too."""
        return (self.G - self._offset
                + sum(p.size for p in self._retry)
                + sum(lease.work for lease in self._leases))

    def outstanding(self) -> int:
        """Packets handed out via next_packet/acquire and not yet
        released (approximate under concurrent mutation)."""
        return sum(self._outstanding)

    def drained(self) -> bool:
        """Lock-free exactly-once drain test for engines.

        Sound because (a) a packet is continuously visible in
        ``remaining()`` until it is popped, and in ``outstanding`` from
        *before* that pop until its ``release`` (which follows its commit
        or its requeue), and (b) the only transition that re-adds work —
        a requeue — bumps ``_retry_epoch``, so the re-read detects any
        race that could hide a packet between the two reads."""
        e0 = self._retry_epoch
        if self.remaining() != 0:
            return False
        if sum(self._outstanding) != 0:
            return False
        return self._retry_epoch == e0

    def sched_wait_s(self) -> List[float]:
        """Per-device wall time spent inside dispatch-path scheduler
        calls (next_packet / lease / steal): lock waits + carve work."""
        return list(self._wait_s)

    def lock_crossings_by_device(self) -> List[int]:
        """Per-device global-lock crossings on the dispatch hot path
        (next_packet / lease / steal).  Sums to
        ``stats.lock_crossings``; the energy meter charges each
        crossing at the crossing device's ``PowerModel.lock_j``."""
        return list(self._crossings)

    def update_power(self, device: int, power: float) -> None:
        """Online power re-estimation hook (HGuidedOpt uses it)."""
        with self._lock:
            self.devices[device].power = max(power, 1e-9)

    # -- internals ----------------------------------------------------------
    def _pop_retry_locked(self, device: int) -> Optional[Packet]:
        """FIFO retry re-issue: the OLDEST requeued packet goes out first
        (LIFO would re-issue a straggler's early packet last, extending
        the tail).  Provenance: original seq, retried=True."""
        if not self._retry:
            return None
        pkt = self._retry.popleft()
        return dataclasses.replace(pkt, device=device, retried=True)

    def _requeue_locked(self, pkt: Packet) -> None:
        self._retry.append(pkt)
        self._retry_epoch += 1

    def _pop_local(self, device: int) -> Optional[Packet]:
        """Pop the device's lease.  The outstanding claim is taken BEFORE
        the packet leaves the lease, so the packet is never invisible to
        ``drained()`` readers (remaining first, outstanding second)."""
        lease = self._leases[device]
        with lease._lock:
            if not lease._dq:
                return None
            self._outstanding[device] += 1
            pkt = lease._dq.popleft()
        self.stats.local_pops += 1
        return pkt

    def _refill(self, device: int) -> int:
        """Hook: pull new work into the device's lease; returns packets
        gained.  Base: global carve.  HGuidedSteal: steal first."""
        return self.lease(device)

    def _adaptive_k_locked(self, device: int) -> int:
        """Grow the lease geometrically while one lock crossing costs
        more than ``lease_overhead_frac`` of the lease's compute time;
        shrink it when packets are slow (balance beats amortization)."""
        k = self._lease_k[device]
        lat = self._lease_lat[device]
        if lat is not None and lat > 0:
            target = self.lease_overhead_s / (self.lease_overhead_frac * lat)
            if k < target:
                k = min(k * 2, self.lease_k_max)
            elif k > 2 * target:
                k = max(1, k // 2)
        self._lease_k[device] = k
        return k

    def _release_dead_locked(self, device: int) -> None:
        """Hook: pre-assignment schedulers (Static*) release a dead
        device's unclaimed chunk here.  Pool-carving schedulers need do
        nothing (survivors drain the shared queue)."""

    def _bump(self) -> int:
        self._seq += 1
        return self._seq - 1

    def _packet(self, offset: int, size: int, device: int) -> Packet:
        """Mint a packet: relative dim-0 carve + its absolute row panel."""
        return Packet(offset, size, self._bump(), device,
                      region=self.region.row_panel(offset, size))

    def _take(self, size: int, device: int) -> Optional[Packet]:
        left = self.G - self._offset
        if left <= 0:
            return None
        size = min(size, left)
        pkt = self._packet(self._offset, size, device)
        self._offset += size
        return pkt

    def _align(self, size: int) -> int:
        return max(self.lws, self.lws * math.ceil(size / self.lws))

    def _carve(self, device: int) -> Optional[Packet]:
        raise NotImplementedError


class StaticScheduler(SchedulerBase):
    """One power-proportional packet per device. ``order`` gives the delivery
    order of the chunks over the work range; ``reverse`` flips the default
    order (paper: Static vs Static rev — ``static_rev`` is registered as this
    class with ``reverse=True``, a plain config rather than a closure)."""

    def __init__(self, total_work, lws, devices,
                 order: Optional[List[int]] = None, reverse: bool = False):
        super().__init__(total_work, lws, devices)
        if order is None:
            order = list(range(len(devices)))
            if reverse:
                order.reverse()
        self.order = list(order)
        total_p = sum(d.power for d in self.devices)
        sizes = {}
        acc = 0
        for idx, di in enumerate(self.order):
            if idx == len(self.order) - 1:
                sizes[di] = self.G - acc
            else:
                s = min(self._align(self.G * self.devices[di].power / total_p),
                        self.G - acc)
                sizes[di] = s
                acc += s
        self._sizes = sizes
        self._given: Dict[int, bool] = {}

    def _chunk_bounds(self, device: int) -> Tuple[int, int]:
        # chunks are laid out in `order`: compute this device's offset
        off = 0
        for di in self.order:
            if di == device:
                break
            off += self._sizes[di]
        return off, self._sizes[device]

    def _carve(self, device: int) -> Optional[Packet]:
        if self._given.get(device):
            return None
        off, size = self._chunk_bounds(device)
        if size <= 0 or off >= self.G:
            self._given[device] = True
            return None
        self._given[device] = True
        return self._packet(off, min(size, self.G - off), device)

    def _release_dead_locked(self, device: int) -> None:
        # a dead device's unclaimed pre-assigned chunk is released to the
        # retry queue so survivors can absorb it (it would strand otherwise:
        # _carve only hands a chunk to its owner)
        if self._given.get(device):
            return
        self._given[device] = True
        off, size = self._chunk_bounds(device)
        size = min(size, self.G - off)
        if size > 0 and off < self.G:
            self._requeue_locked(self._packet(off, size, device))

    def _remaining_locked(self) -> int:  # static: all work pre-assigned
        done = sum(self._sizes[d] for d, g in self._given.items() if g)
        return (self.G - done + sum(p.size for p in self._retry)
                + sum(lease.work for lease in self._leases))


class DynamicScheduler(SchedulerBase):
    """n_packets equal chunks from an atomic queue (paper's Dynamic)."""

    def __init__(self, total_work, lws, devices, n_packets: int = 128):
        super().__init__(total_work, lws, devices)
        self.packet_size = self._align(math.ceil(self.G / n_packets))

    def _carve(self, device: int) -> Optional[Packet]:
        return self._take(self.packet_size, device)


class HGuidedScheduler(SchedulerBase):
    """The paper's HGuided (eq. in §II-B)."""

    def _carve(self, device: int) -> Optional[Packet]:
        d = self.devices[device]
        total_p = sum(x.power for x in self.devices)
        G_r = self.G - self._offset
        if G_r <= 0:
            return None
        n = len(self.devices)
        raw = math.ceil(G_r * d.power / (d.k * n * total_p))
        size = max(d.min_mult * self.lws, self._align(raw))
        return self._take(self._cap_size(device, size), device)

    def _cap_size(self, device: int, size: int) -> int:
        """Hook for subclasses to bound a carved packet (deadline caps)."""
        return size


def tuned_profiles(devices: Sequence[DeviceProfile]) -> List[DeviceProfile]:
    """Apply the paper's tuning laws by power ranking: strongest gets
    (m=30, k=1), mid (15, 1.5), weakest (1, 3.5); for n != 3 interpolate in
    rank space.  Single-k fallback (paper conclusion d) is k=2."""
    n = len(devices)
    out = [DeviceProfile(d.name, d.power, d.min_mult, d.k,
                         power_model=d.power_model) for d in devices]
    if n == 1:
        out[0].min_mult, out[0].k = 1, 2.0
        return out
    ranked = sorted(range(n), key=lambda i: devices[i].power)
    m_lo, m_hi = 1, 30
    k_lo, k_hi = 1.0, 3.5
    for rank, i in enumerate(ranked):
        t = rank / (n - 1)            # 0 = weakest, 1 = strongest
        if n == 3:                    # exact paper combo
            m = (1, 15, 30)[rank]
            k = (3.5, 1.5, 1.0)[rank]
        else:
            m = round(m_lo + (m_hi - m_lo) * t)
            k = k_hi + (k_lo - k_hi) * t
        out[i].min_mult = int(m)
        out[i].k = float(k)
    return out


class HGuidedOptScheduler(HGuidedScheduler):
    """HGuided with the paper's tuned (m, k) pairs + online EWMA powers.

    The minimum-packet multipliers are additionally capped at 1/4 of the
    device's fair share: the paper's m=30 is tuned for a 3-device desktop;
    at fleet scale a large forced minimum would hand a group half its share
    in one unadaptable packet."""

    def __init__(self, total_work, lws, devices, ewma: float = 0.5):
        region = as_region(total_work, lws)
        G, lws = region.dims[0].size, region.dims[0].lws
        profs = tuned_profiles(devices)
        total_p = sum(d.power for d in profs) or 1.0
        n = len(profs)
        for d in profs:
            share_wg = G * d.power / total_p
            d.min_mult = max(1, min(d.min_mult, int(share_wg / (4 * lws))))
            if n > 8:
                # fleet-scale adaptation (beyond paper): with near-equal
                # groups (a) k=1 issues a device's whole fair share as its
                # first packet and removes all adaptation headroom — the
                # paper's single-k conclusion (k=2) is the right floor; and
                # (b) every group is "untuned", so the paper's conclusion
                # (e) applies: keep m=1 — a forced minimum packet is what
                # strands work on stragglers at the tail
                d.k = max(d.k, 2.0)
                d.min_mult = 1
        super().__init__(total_work, lws, profs)
        self.ewma = ewma
        self._obs: Dict[int, float] = {}

    def observe(self, device: int, wg_per_s: float) -> None:
        """Feed measured throughput; re-rank powers online."""
        prev = self._obs.get(device)
        cur = wg_per_s if prev is None else (self.ewma * wg_per_s
                                             + (1 - self.ewma) * prev)
        self._obs[device] = cur
        self.update_power(device, cur)


class HGuidedDeadlineScheduler(HGuidedOptScheduler):
    """Deadline-aware HGuidedOpt for time-constrained serving.

    On top of the tuned (m, k) pairs and online EWMA powers, every carved
    packet is capped so its *predicted* execution time on the target device
    fits inside a fraction of the tightest remaining slack:

        cap_i = slack * slack_fraction * P_i      (work-groups)

    The caller (CoexecServer / simulate_serving) refreshes the slack before
    each dispatch round via ``update_slack(min_deadline - now)``.  As
    deadlines close in, packets shrink toward ``lws`` — more scheduling
    points, finer EDF admission, less work stranded behind a long packet
    when a request is about to miss.  With no deadline pressure
    (``slack=None``) it degenerates to HGuidedOpt exactly.
    """

    def __init__(self, total_work, lws, devices, ewma: float = 0.5,
                 slack_fraction: float = 0.5,
                 slack_s: Optional[float] = None):
        super().__init__(total_work, lws, devices, ewma=ewma)
        assert 0.0 < slack_fraction <= 1.0
        self.slack_fraction = slack_fraction
        self._slack: Optional[float] = None
        if slack_s is not None:     # construction-time slack (session submits
            self.update_slack(slack_s)   # build one scheduler per round)

    def update_slack(self, slack_s: Optional[float]) -> None:
        """Set the tightest remaining slack (seconds); None lifts the cap."""
        # plain attribute store (atomic in CPython); _carve runs under the
        # scheduler lock and only reads it once
        self._slack = None if slack_s is None else max(0.0, float(slack_s))

    def _cap_size(self, device: int, size: int) -> int:
        slack = self._slack
        if slack is None:
            return size
        d = self.devices[device]
        cap_wg = d.power * slack * self.slack_fraction
        # floor-align to lws but never below one work-group unit: a starved
        # device must still drain the queue, one minimal packet at a time
        cap = max(self.lws, self.lws * int(cap_wg // self.lws))
        return min(size, cap)


class HGuidedEnergyScheduler(HGuidedDeadlineScheduler):
    """Energy-capped HGuided for joule-constrained runs.

    The deadline scheduler's slack cap, rotated into the energy
    dimension: every carved packet's *predicted* joules are charged
    against a per-run ``energy_budget_j``, and packets for inefficient
    devices shrink as the budget's headroom burns down.

    Per device the marginal cost is its busy efficiency
    ``j_i = busy_w_i / P_i`` (J per work-group at full speed, from the
    profile's :class:`repro_torch.energy.model.PowerModel`).  The floor cost of
    the remaining work is ``G_r * j_min`` — what it would cost if the
    most-efficient alive device ran all of it.  The spendable *headroom*
    is what the budget allows above that floor:

        headroom = (budget - spent) - G_r * j_min
        cap_i    = headroom * energy_fraction / (j_i - j_min)

    The most-efficient device is never capped (its packets cost the
    floor rate); every other device may burn at most a fraction of the
    headroom per packet, so as the budget binds their packets shrink —
    and once the headroom cannot afford even one ``lws`` packet above
    the floor rate, the device is *denied fresh work outright*: it
    retires from the run and the split degrades toward the
    most-efficient device, which drains the tail alone.  (Shrinking
    packets without denial would not shift work — a fast device pulling
    ``lws``-sized packets still pulls at nearly full rate; only refusal
    moves its share.)  This trades makespan for joules, exactly the
    J-vs-s flip the green-computing survey measures.  The budget stays
    a soft cap: predicted spend can overshoot by the packets already in
    flight when it bound.  Drain stays guaranteed because the
    most-efficient *alive* device is never denied (``mark_dead``
    re-elects it), and retry packets are never refused.  With
    ``energy_budget_j=None`` (or joule-blind profiles) it degenerates
    to HGuidedDeadline exactly.

    Deadline and energy caps compose: serving callers still feed
    ``update_slack`` and both caps apply (the tighter one wins).
    """

    def __init__(self, total_work, lws, devices, ewma: float = 0.5,
                 slack_fraction: float = 0.5,
                 slack_s: Optional[float] = None,
                 energy_budget_j: Optional[float] = None,
                 energy_fraction: float = 0.5):
        super().__init__(total_work, lws, devices, ewma=ewma,
                         slack_fraction=slack_fraction, slack_s=slack_s)
        assert 0.0 < energy_fraction <= 1.0
        self.energy_budget_j = None if energy_budget_j is None \
            else float(energy_budget_j)
        self.energy_fraction = energy_fraction
        self._spent_j = 0.0           # predicted joules charged at issue

    def predicted_spend_j(self) -> float:
        """Joules the issued packets are predicted to burn (requeued
        packets are conservatively re-charged on re-issue)."""
        with self._lock:
            return self._spent_j

    def _j_per_wg_locked(self, device: int) -> float:
        d = self.devices[device]
        pm = d.power_model
        if pm is None or pm.busy_w <= 0:
            return 0.0                # unmodeled device: cannot predict
        return pm.busy_w / max(d.power, 1e-9)

    def _min_j_per_wg_locked(self) -> float:
        vals = [self._j_per_wg_locked(i) for i in range(len(self.devices))
                if i not in self._dead]
        vals = [v for v in vals if v > 0]
        return min(vals) if vals else 0.0

    def _allow_wg_locked(self, device: int) -> Optional[float]:
        """Work-groups of headroom this device may burn per packet, or
        None when it is exempt (no budget / most-efficient / unmodeled /
        already dead)."""
        budget = self.energy_budget_j
        if budget is None or device in self._dead:
            return None
        j_d = self._j_per_wg_locked(device)
        j_min = self._min_j_per_wg_locked()
        if j_d <= 0 or j_min <= 0 or j_d <= j_min * (1 + 1e-12):
            return None               # most-efficient (or unmodeled)
        headroom = ((budget - self._spent_j)
                    - self._remaining_locked() * j_min)
        return max(0.0, headroom) * self.energy_fraction / (j_d - j_min)

    def _cap_size(self, device: int, size: int) -> int:
        size = super()._cap_size(device, size)     # deadline cap first
        allow_wg = self._allow_wg_locked(device)
        if allow_wg is None:
            return size
        cap = max(self.lws, self.lws * int(allow_wg // self.lws))
        return min(size, cap)

    def _charge_locked(self, device: int, size: int) -> None:
        if self.energy_budget_j is not None:
            self._spent_j += size * self._j_per_wg_locked(device)

    def _carve(self, device: int) -> Optional[Packet]:
        # deny-and-retire: when the headroom cannot afford even one
        # ``lws`` packet above the floor rate, this device gets no fresh
        # work — refusal (not shrinkage) is what actually moves its
        # share onto the efficient device.  Retries are never refused.
        allow_wg = self._allow_wg_locked(device)
        if allow_wg is not None and allow_wg < self.lws:
            return None
        pkt = super()._carve(device)
        if pkt is not None:
            self._charge_locked(device, pkt.size)
        return pkt

    def _pop_retry_locked(self, device: int) -> Optional[Packet]:
        pkt = super()._pop_retry_locked(device)
        if pkt is not None:
            self._charge_locked(device, pkt.size)
        return pkt


class HGuidedStealScheduler(HGuidedDeadlineScheduler):
    """The repo's new load-balancing algorithm: lease-amortized HGuided
    dispatch with a work-stealing tail.

    Carving law = HGuidedDeadline (tuned (m, k) pairs, online EWMA
    powers, optional slack cap — with ``slack_s=None`` it sizes packets
    exactly like HGuidedOpt).  What changes is the *hand-off*: devices
    dispatch through ``acquire()`` (leased packet plans, one global lock
    crossing per plan), and an idle device first drains its own lease,
    then **steals half the largest victim lease**, and only then falls
    back to the global carve.  Stealing keeps every device busy through
    the run tail — the stolen packets are exactly the ones a loaded
    device had planned but not started — while the lease amortization
    removes the per-packet lock hand-off the paper's management-overhead
    accounting charges against co-execution."""

    def _refill(self, device: int) -> int:
        # cheap unlocked peek (len() is GIL-atomic): only pay the steal's
        # lock crossing when some victim lease is plausibly non-empty
        if any(len(lease) for i, lease in enumerate(self._leases)
               if i != device):
            if self.steal(device):
                return 1
        return self.lease(device)


class GraphProgress:
    """Work accounting across the many scheduler contexts of one run graph.

    Each DAG node dispatches through its *own* scheduler instance
    (one ``_RunContext`` per submit), so no single scheduler can answer
    "how much of the graph is left?".  This tracker can: every submitted
    node registers its total dim-0 work up front; when its run context
    constructs its scheduler it attaches it (``remaining()`` then reads
    the live lease/exact-cover bookkeeping instead of the static total);
    terminal nodes — committed, failed, cancelled — drop out.

    Thread-safe: the session registers on the submit thread, run contexts
    attach from pooled runner threads, and ``remaining()`` may be polled
    by any observer.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._total: Dict[object, int] = {}      # node -> registered wg
        self._live: Dict[object, SchedulerBase] = {}

    def register(self, key: object, total_work: int) -> None:
        with self._lock:
            self._total[key] = int(total_work)

    def attach(self, key: object, sched: "SchedulerBase") -> None:
        """Swap the node's static total for its live scheduler."""
        with self._lock:
            if key in self._total:
                self._live[key] = sched

    def complete(self, key: object) -> None:
        """Drop a terminal node (done, failed, or cancelled)."""
        with self._lock:
            self._total.pop(key, None)
            self._live.pop(key, None)

    def remaining(self) -> int:
        """Outstanding work-groups across every non-terminal node of the
        graph: live schedulers report their exact lease/retry/pool
        accounting; not-yet-dispatched nodes report their full totals."""
        with self._lock:
            items = list(self._total.items())
            live = dict(self._live)
        out = 0
        for key, total in items:
            sched = live.get(key)
            out += sched.remaining() if sched is not None else total
        return out

    def nodes(self) -> Dict[object, int]:
        """Per-node outstanding work (same accounting as ``remaining``)."""
        with self._lock:
            items = list(self._total.items())
            live = dict(self._live)
        return {key: (live[key].remaining() if key in live else total)
                for key, total in items}

    def __len__(self) -> int:
        with self._lock:
            return len(self._total)


# ---------------------------------------------------------------- registry
@dataclass(frozen=True)
class SchedulerSpec:
    """Registry entry: the scheduler class plus its default constructor
    kwargs (how ``static_rev`` stays a config instead of a closure)."""
    cls: type
    defaults: Mapping[str, object] = field(default_factory=dict)


_REGISTRY: Dict[str, SchedulerSpec] = {}

# Back-compat view: name -> zero-config constructor.  Kept in lockstep with
# _REGISTRY by register/unregister; prefer make_scheduler()/the registry
# helpers in new code.
SCHEDULERS: Dict[str, Callable[..., "SchedulerBase"]] = {}


def register_scheduler(name: str, cls: type, *,
                       defaults: Optional[Mapping[str, object]] = None,
                       overwrite: bool = False) -> type:
    """Register a scheduler under ``name`` (the Tier-3 plugin hook).

    ``cls`` must subclass SchedulerBase with the ``(total_work, lws,
    devices, **kw)`` constructor contract; ``defaults`` are kwargs merged
    under any caller-supplied ones.  Returns ``cls`` so it can be used as a
    decorator: ``@register_scheduler("mine", defaults={...})`` is spelled
    ``register_scheduler("mine", MyScheduler)``.
    """
    if not (isinstance(cls, type) and issubclass(cls, SchedulerBase)):
        raise TypeError(f"scheduler {name!r} must be a SchedulerBase "
                        f"subclass, got {cls!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scheduler {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = SchedulerSpec(cls, dict(defaults or {}))
    _REGISTRY[name] = spec
    SCHEDULERS[name] = cls if not spec.defaults else \
        functools.partial(cls, **spec.defaults)
    return cls


def unregister_scheduler(name: str) -> None:
    _REGISTRY.pop(name, None)
    SCHEDULERS.pop(name, None)


def available_schedulers() -> List[str]:
    return sorted(_REGISTRY)


def scheduler_spec(name: str) -> SchedulerSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; registered: "
                       f"{available_schedulers()}") from None


def scheduler_accepts(name: str, param: str) -> bool:
    """True if ``name``'s constructor takes ``param`` (capability probe —
    e.g. only deadline-aware schedulers accept ``slack_s``).

    Walks the MRO so a plugin subclass with a ``**kwargs`` passthrough
    constructor still advertises its base's parameters; an explicit
    signature without ``param`` (and no ``**kwargs``) stops the walk."""
    for klass in scheduler_spec(name).cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters
        if param in params:
            return True
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
            return False
    return False


def make_scheduler(name: str, total_work: Union[int, Region], lws: int,
                   devices: Sequence[DeviceProfile], **kw) -> SchedulerBase:
    """Build a registered scheduler over ``total_work`` — a Region
    (NDRange; ``lws`` then comes from ``dims[0].lws``) or a legacy flat
    work-group count."""
    spec = scheduler_spec(name)
    merged = {**spec.defaults, **kw}
    return spec.cls(total_work, lws, devices, **merged)


register_scheduler("static", StaticScheduler)
register_scheduler("static_rev", StaticScheduler, defaults={"reverse": True})
register_scheduler("dynamic", DynamicScheduler)
register_scheduler("hguided", HGuidedScheduler)
register_scheduler("hguided_opt", HGuidedOptScheduler)
register_scheduler("hguided_deadline", HGuidedDeadlineScheduler)
register_scheduler("hguided_energy", HGuidedEnergyScheduler)
register_scheduler("hguided_steal", HGuidedStealScheduler)


def rotate_static_order(name: str, n_devices: int,
                        round_index: int) -> Optional[List[int]]:
    """Weighted round-robin delivery order for per-round Static dispatch.

    Serving engines instantiate one scheduler per dispatch round; without
    rotating Static's fixed delivery order across rounds, every small
    round lands whole on the first-ordered device while the rest of the
    fleet idles.  Returns None for non-static schedulers (no override).
    Shared by CoexecServer and simulate_serving so the discrete-event twin
    cannot drift from the threaded server.
    """
    if name != "static":
        return None
    return [(j + round_index) % n_devices for j in range(n_devices)]
