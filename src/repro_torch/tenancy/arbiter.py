"""The fleet arbiter: fair-share device grants for concurrent sessions.

One :class:`FleetArbiter` owns the devices, the :class:`WorkerPool`, and
the shared :class:`BufferArena`.  Tenant sessions register with a
:class:`TenantConfig` (weight, priority, exclusive) and from then on
every device-loop packet pull asks the arbiter for permission first:

``begin_packet(device)`` -- granted only if the tenant wins the current
election AND the device's previous holder has no packet in flight there
(grants flip **only at packet boundaries**, never mid-packet, so every
tenant's runs keep the solo-session exact-cover/phase/energy
identities).  A denied session reclaims its scheduler lease
(``SchedulerBase.reclaim_lease``) and re-polls; the reclaimed packets go
back to the retry pool and are re-pulled when the grant returns.

The election is weighted virtual time (stride scheduling): finishing a
packet of ``wg`` work-groups advances the tenant's virtual time by
``wg / weight``, and the fleet is granted to the active tenant with the
lowest virtual time -- so long-run work shares converge to the quota
weights.  Higher ``priority`` classes win outright while they have
demand.  A tenant (re)activating after idling has its virtual time
caught up to the active minimum, so sleepers cannot hoard credit.

``exclusive=True`` tenants fence the fleet: ``begin_run`` queues on a
FIFO fence, the election starves co-tenants' new grants, and the run
starts only once every other tenant has zero packets in flight anywhere
-- bounded takeover latency of one packet per device.  Per-packet
``(tenant, device, t0, t1)`` windows are recorded so isolation is
*verifiable*, not assumed (:func:`exclusive_overlaps`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Sequence

from repro_torch.core.membuf import ArenaPartition, BufferArena
from repro_torch.core.runtime import WorkerPool
from repro_torch.core.scheduler import SchedStats

__all__ = [
    "FleetArbiter",
    "PacketWindow",
    "TenantConfig",
    "TenantHandle",
    "exclusive_overlaps",
    "fair_share_index",
]


@dataclass(frozen=True)
class TenantConfig:
    """Static identity + policy of one tenant.

    ``weight`` is the fair-share quota weight (work shares converge to
    ``weight / sum(weights of active tenants)``); ``priority`` classes
    are strict (higher always wins while it has demand); ``exclusive``
    tenants fence the whole fleet for each run.  ``arena_cap_bytes``
    optionally bounds the tenant's free bytes in the shared arena.
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    exclusive: bool = False
    arena_cap_bytes: Optional[int] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if "::" in self.name:
            raise ValueError("tenant name must not contain '::'")
        if not (self.weight > 0):
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")


class PacketWindow(NamedTuple):
    """One executed packet's wall-clock occupancy of one device."""

    tenant: str
    device: int
    t0: float
    t1: float
    wg: int


class TenantHandle:
    """A registered tenant's live state (owned by the arbiter's lock).

    Sessions hold one of these; the runtime calls ``begin_packet`` /
    ``end_packet`` around every device pull and ``begin_run`` /
    ``end_run`` around every run.  All mutation happens under the
    arbiter's condition variable.
    """

    def __init__(self, arbiter: "FleetArbiter", config: TenantConfig,
                 demand: Optional[Callable[[], bool]],
                 partition: ArenaPartition):
        self.arbiter = arbiter
        self.config = config
        self.arena = partition
        self._demand = demand
        self.usage_wg = 0          # total work-groups executed
        self.vt = 0.0              # virtual time (wg / weight)
        self.inflight: Dict[int, int] = {}   # device -> packets in flight
        self.active_runs = 0
        self.runs = 0
        self.denials = 0           # begin_packet refusals (observability)
        self.sched_stats = SchedStats()      # per-tenant rollup across runs
        self.closed = False

    @property
    def name(self) -> str:
        return self.config.name

    def has_demand(self) -> bool:
        if self._demand is None:
            return self.active_runs > 0
        try:
            return bool(self._demand())
        except Exception:
            return False

    def inflight_total(self) -> int:
        return sum(self.inflight.values())

    # -- runtime hooks (delegate to the arbiter) ----------------------------
    def begin_packet(self, device: int) -> bool:
        return self.arbiter._begin_packet(self, device)

    def end_packet(self, device: int, wg: int, t0: float) -> None:
        self.arbiter._end_packet(self, device, wg, t0)

    def begin_run(self) -> None:
        self.arbiter._begin_run(self)

    def end_run(self) -> None:
        self.arbiter._end_run(self)

    def merge_stats(self, stats: SchedStats) -> None:
        with self.arbiter._cv:
            self.sched_stats.merge(stats)

    def __repr__(self) -> str:
        return (f"TenantHandle({self.name!r}, w={self.config.weight}, "
                f"prio={self.config.priority}, usage={self.usage_wg}wg, "
                f"vt={self.vt:.1f})")


class FleetArbiter:
    """Owns the devices, pool, and arena; grants devices to tenants.

    See the module docstring for the grant/election/fence semantics.
    ``record_windows=True`` keeps up to ``max_windows`` per-packet device
    windows for isolation audits (benchmarks/tests); disable it for
    long-lived services.
    """

    def __init__(self, devices: Sequence, *, name: str = "fleet",
                 arena_capacity_bytes: int = 256 << 20, arena_ring: int = 2,
                 record_windows: bool = True, max_windows: int = 200_000):
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("FleetArbiter needs at least one device")
        self.name = name
        self.pool = WorkerPool(name=f"{name}-pool")
        self.arena = BufferArena(capacity_bytes=arena_capacity_bytes,
                                 ring=arena_ring, name=f"{name}-arena")
        self._cv = threading.Condition()
        self._tenants: Dict[str, TenantHandle] = {}
        self._grant: Dict[int, Optional[TenantHandle]] = {}
        self._fence: Deque[TenantHandle] = deque()
        self._exclusive: Optional[TenantHandle] = None
        self._windows: List[PacketWindow] = []
        self._history: Dict[str, Dict] = {}  # departed tenants' final rows
        self._record_windows = bool(record_windows)
        self._max_windows = int(max_windows)
        self._closed = False
        self.grants = 0        # grant flips between tenants
        self.preemptions = 0   # flips that took the device from a tenant
        #   that still had demand (i.e. true preemptions, not handoffs)

    # -- tenant lifecycle ---------------------------------------------------
    def register(self, config: TenantConfig,
                 demand: Optional[Callable[[], bool]] = None) -> TenantHandle:
        """Admit a tenant.  ``demand`` is polled during elections; it
        should be cheap and lock-light (the session passes its graph's
        ``remaining() > 0``).  The newcomer's virtual time joins at the
        current minimum so it neither starves nor monopolizes."""
        with self._cv:
            if self._closed:
                raise RuntimeError(f"arbiter {self.name!r} is closed")
            if config.name in self._tenants:
                raise ValueError(f"tenant {config.name!r} already registered")
            partition = ArenaPartition(self.arena, config.name,
                                       cap_bytes=config.arena_cap_bytes)
            handle = TenantHandle(self, config, demand, partition)
            vts = [h.vt for h in self._tenants.values() if not h.closed]
            if vts:
                handle.vt = min(vts)
            self._tenants[config.name] = handle
            return handle

    def unregister(self, handle: TenantHandle) -> None:
        """Retire a tenant: drop its grants, fence slot, and arena keys.
        Idempotent; the session calls this from ``close()``."""
        with self._cv:
            handle.closed = True
            self._tenants.pop(handle.name, None)
            self._history[handle.name] = self._row_locked(handle)
            for dev, holder in list(self._grant.items()):
                if holder is handle:
                    self._grant[dev] = None
            try:
                self._fence.remove(handle)
            except ValueError:
                pass
            if self._exclusive is handle:
                self._exclusive = None
            self._cv.notify_all()
        handle.arena.close()

    def close(self) -> None:
        """Shut the fleet down.  Close tenant sessions first; any still
        registered are force-unregistered."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            stale = list(self._tenants.values())
        for h in stale:
            self.unregister(h)
        self.arena.close()
        self.pool.close()

    # -- election -----------------------------------------------------------
    def _elect_locked(self, asking: TenantHandle) -> TenantHandle:
        """Who should the fleet serve right now?  Exclusive holder first,
        then the fence head (starve co-tenants so the fence can drain),
        then the highest priority class with demand, lowest virtual time
        within it.  With no demand anywhere, the asking tenant wins --
        drain-tail probes must never stall."""
        if self._exclusive is not None:
            return self._exclusive
        if self._fence:
            return self._fence[0]
        cands = [h for h in self._tenants.values()
                 if not h.closed and h.active_runs > 0 and h.has_demand()]
        if not cands:
            return asking
        top = max(h.config.priority for h in cands)
        cands = [h for h in cands if h.config.priority == top]
        return min(cands, key=lambda h: (h.vt, h.name))

    def _begin_packet(self, handle: TenantHandle, device: int) -> bool:
        """Permission to pull one packet on ``device``.  False means:
        reclaim your lease and re-poll -- either you lost the election or
        the previous holder still has a packet mid-flight there."""
        with self._cv:
            if handle.closed or self._closed:
                return False
            winner = self._elect_locked(handle)
            if winner is not handle:
                handle.denials += 1
                return False
            holder = self._grant.get(device)
            if (holder is not None and holder is not handle
                    and holder.inflight.get(device, 0) > 0):
                handle.denials += 1
                return False  # packet boundary not reached yet
            if holder is not handle:
                self._grant[device] = handle
                self.grants += 1
                if holder is not None and not holder.closed \
                        and holder.has_demand():
                    self.preemptions += 1
            handle.inflight[device] = handle.inflight.get(device, 0) + 1
            return True

    def _end_packet(self, handle: TenantHandle, device: int, wg: int,
                    t0: float) -> None:
        """Packet done (or the pull came up empty: ``wg == 0``).  Accrues
        usage/virtual time, records the device window, and wakes fence
        waiters when the tenant goes idle on this device."""
        with self._cv:
            n = handle.inflight.get(device, 0) - 1
            handle.inflight[device] = max(0, n)
            if wg > 0:
                handle.usage_wg += wg
                handle.vt += wg / handle.config.weight
                if (self._record_windows
                        and len(self._windows) < self._max_windows):
                    self._windows.append(PacketWindow(
                        handle.name, device, t0, time.perf_counter(), wg))
            if handle.inflight[device] <= 0:
                self._cv.notify_all()

    # -- run lifecycle ------------------------------------------------------
    def _others_idle_locked(self, handle: TenantHandle) -> bool:
        return all(h is handle or h.inflight_total() == 0
                   for h in self._tenants.values())

    def _begin_run(self, handle: TenantHandle) -> None:
        with self._cv:
            if handle.config.exclusive and self._exclusive is not handle:
                self._fence.append(handle)
                while not (self._fence and self._fence[0] is handle
                           and self._others_idle_locked(handle)):
                    if handle.closed or self._closed:
                        try:
                            self._fence.remove(handle)
                        except ValueError:
                            pass
                        raise RuntimeError(
                            f"tenant {handle.name!r} closed at the fence")
                    self._cv.wait()
                self._fence.popleft()
                self._exclusive = handle
            if handle.active_runs == 0:
                others = [h.vt for h in self._tenants.values()
                          if h is not handle and not h.closed
                          and h.active_runs > 0]
                if others:
                    handle.vt = max(handle.vt, min(others))
            handle.active_runs += 1
            handle.runs += 1

    def _end_run(self, handle: TenantHandle) -> None:
        with self._cv:
            handle.active_runs -= 1
            if handle.active_runs == 0 and self._exclusive is handle:
                self._exclusive = None
            self._cv.notify_all()

    # -- observability ------------------------------------------------------
    def windows(self) -> List[PacketWindow]:
        with self._cv:
            return list(self._windows)

    def _row_locked(self, h: TenantHandle) -> Dict:
        return {
            "weight": h.config.weight,
            "priority": h.config.priority,
            "exclusive": h.config.exclusive,
            "usage_wg": h.usage_wg,
            "vt": h.vt,
            "runs": h.runs,
            "denials": h.denials,
            "sched": dataclasses.asdict(h.sched_stats),
        }

    def tenant_stats(self, include_departed: bool = False) -> Dict[str, Dict]:
        """Per-tenant accounting snapshot: usage, share vs quota, and the
        scheduler-stats rollup.  ``share``/``quota`` are normalized over
        the returned tenants.  ``include_departed=True`` adds the final
        rows of unregistered tenants (a re-registered name's live row
        wins), so post-hoc fairness audits survive session close."""
        with self._cv:
            out = {h.name: self._row_locked(h)
                   for h in self._tenants.values()}
            if include_departed:
                for name, row in self._history.items():
                    out.setdefault(name, dict(row))
            total_wg = sum(r["usage_wg"] for r in out.values())
            total_w = sum(r["weight"] for r in out.values())
            for r in out.values():
                r["share"] = r["usage_wg"] / total_wg if total_wg else 0.0
                r["quota"] = r["weight"] / total_w if total_w else 0.0
            return out

    def __repr__(self) -> str:
        with self._cv:
            return (f"FleetArbiter({self.name!r}, devices={len(self.devices)},"
                    f" tenants={sorted(self._tenants)}, grants={self.grants},"
                    f" preemptions={self.preemptions})")


# --------------------------------------------------------------------------
# Audit helpers
# --------------------------------------------------------------------------


def exclusive_overlaps(windows: Sequence[PacketWindow],
                       tenant: str) -> int:
    """Number of per-device packet windows of ``tenant`` that overlap in
    wall-clock time with any co-tenant's window on the same device.  Zero
    is the exclusive-mode isolation guarantee."""
    n = 0
    by_dev: Dict[int, List[PacketWindow]] = {}
    for w in windows:
        by_dev.setdefault(w.device, []).append(w)
    for ws in by_dev.values():
        mine = [w for w in ws if w.tenant == tenant]
        theirs = [w for w in ws if w.tenant != tenant]
        for a in mine:
            for b in theirs:
                if a.t0 < b.t1 and b.t0 < a.t1:
                    n += 1
    return n


def fair_share_index(stats: Dict[str, Dict]) -> float:
    """min over tenants of ``1 - |share/quota - 1|`` (clamped at 0):
    1.0 is perfect weighted fairness, 0.9 means the worst tenant's share
    is within +-10% of its quota.  Tenants with zero quota are skipped."""
    idx = 1.0
    for s in stats.values():
        if s["quota"] <= 0:
            continue
        idx = min(idx, 1.0 - abs(s["share"] / s["quota"] - 1.0))
    return max(0.0, idx)
