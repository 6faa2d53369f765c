"""Memory subsystem: the buffer arena and the overlapped transfer pipeline.

The paper attributes most of the co-execution penalty in time-constrained
scenarios to runtime management overheads, buffer handling chief among
them; its EngineCL optimizations come from *reusing* buffers across runs
and *hiding* transfer latency behind compute (the DMA/compute-overlap
discipline of the MPSoC offloading literature).  This module is those two
optimizations as first-class, auditable objects:

* :class:`BufferArena` -- a size-bucketed pool of run buffers keyed by
  ``(program, device, shape, dtype)``.  Each key owns a small **ring**
  (default two entries: classic double buffering), so back-to-back warm
  submits of the same workload alternate between recycled buffers instead
  of allocating.  Free entries are bounded by ``capacity_bytes`` with LRU
  eviction; on a key miss the arena first *re-keys* an LRU free entry from
  the same size bucket before allocating fresh memory.  The arena is
  session-owned: ``EngineSession.register_workload`` pre-populates rings,
  ``EngineSession.evict`` / ``close`` drop them.

* :class:`TransferPipeline` -- a per-run stage-in -> compute -> stage-out
  coordinator.  While packet *k* computes on a device thread, packet
  *k+1*'s stage-in (scheduler pull + launch binding, the H2D window) runs
  on a prefetch thread, and packet *k-1*'s stage-out (device->host result
  conversion + commit into the run output, the D2H window) drains on a
  committer thread -- so device threads never block on host staging.

* :class:`BufferPolicy` -- the Runtime buffer-handling policy.  Grown from
  the paper's boolean ``opt_buffers`` into three named contracts (see the
  enum docstring); ``POOLED`` is the default for warm ROI submits.

**Result-lifetime contract (POOLED):** a pooled run's ``output`` is a view
into a recycled arena buffer.  It stays valid until the same workload's
output ring cycles back around (``ring`` submits later); copy it if you
need it past that.  This is exactly the device-buffer semantics the paper's
runtime exposes -- reuse is what makes warm offloads cheap.
"""
from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "ArenaPartition",
    "ArenaStats",
    "BufferArena",
    "BufferLease",
    "BufferPolicy",
    "StageFuture",
    "TransferPipeline",
]


class BufferPolicy(enum.Enum):
    """How the Runtime feeds inputs and commits outputs (grown from the old
    boolean ``opt_buffers``).

    * ``REGISTERED`` -- the paper's buffer-flag optimization: inputs are
      registered once per device as read-only buffers (zero-copy slice
      views feed each packet), outputs are committed in place into a
      per-run preallocated result.
    * ``PER_PACKET`` -- the worst practice the paper's drivers exhibited:
      every packet bulk-copies, results are assembled from per-packet
      copies at the end.  Kept as a measurable baseline.
    * ``POOLED`` -- registered buffers plus the memory subsystem: the run
      output comes from the session's :class:`BufferArena` (no per-run
      allocation), and packets move through the :class:`TransferPipeline`
      (stage-in prefetched, stage-out committed off-thread) so device
      threads never block on host staging.  The default for warm ROI
      submits; pooled outputs are recycled views -- see the result-lifetime
      contract in the module docstring.
    """

    REGISTERED = "registered"
    PER_PACKET = "per_packet"
    POOLED = "pooled"

    @classmethod
    def from_flag(cls, opt_buffers: bool) -> "BufferPolicy":
        return cls.REGISTERED if opt_buffers else cls.PER_PACKET

    @property
    def registered(self) -> bool:
        """Outputs committed in place (no per-packet result copies)."""
        return self is not BufferPolicy.PER_PACKET

    @property
    def pooled(self) -> bool:
        return self is BufferPolicy.POOLED


# --------------------------------------------------------------------------
# Buffer arena
# --------------------------------------------------------------------------

_MIN_BUCKET = 256  # smallest bucket: sub-256B buffers all share one class


def bucket_bytes(nbytes: int) -> int:
    """Size class of a request: next power of two >= nbytes (min 256B).
    Bucketing is what lets a freed buffer back any same-class request,
    not just an identical shape."""
    b = _MIN_BUCKET
    while b < nbytes:
        b <<= 1
    return b


@dataclass
class ArenaStats:
    """Counters snapshot (all monotonic except the gauges at the end)."""

    acquires: int = 0
    hits: int = 0          # exact-key ring hit (a free ring entry)
    rekeys: int = 0        # size-bucket steal from another key
    misses: int = 0        # fresh allocation
    recycles: int = 0      # ring full: oldest leased entry overwritten
    evictions: int = 0     # entries dropped (LRU capacity or evict())
    # gauges
    entries: int = 0
    leases_out: int = 0
    bytes_pooled: int = 0  # free (reusable) bytes
    bytes_leased: int = 0  # bytes currently leased out

    @property
    def bytes_total(self) -> int:
        return self.bytes_pooled + self.bytes_leased


class _Entry:
    """One arena buffer: a raw byte block viewed per-lease as a typed
    (shape, dtype) array."""

    __slots__ = ("key", "raw", "cap", "stamp", "leased")

    def __init__(self, key: Tuple, cap: int, stamp: int):
        self.key = key
        self.raw = np.empty(cap, dtype=np.uint8)
        self.cap = cap
        self.stamp = stamp
        self.leased = False


class BufferLease:
    """A leased arena buffer: ``array`` is the (shape, dtype) view."""

    __slots__ = ("key", "array", "_entry")

    def __init__(self, key: Tuple, array: np.ndarray, entry: _Entry):
        self.key = key
        self.array = array
        self._entry = entry

    def __repr__(self) -> str:
        return f"BufferLease({self.key}, {self.array.shape})"


def arena_key(program: str, device: str, shape, dtype) -> Tuple:
    if np.isscalar(shape):
        shape = (int(shape),)
    else:
        shape = tuple(int(s) for s in shape)
    return (program, device, shape, np.dtype(dtype).str)


class BufferArena:
    """Per-session pool of run buffers (see module docstring).

    Thread-safe.  ``ring`` bounds the outstanding leases per key: the
    ``ring+1``-th acquire of a key recycles (overwrites) the oldest leased
    entry -- double buffering, the caller-visible lifetime contract.
    ``capacity_bytes`` bounds the *free* pool; least-recently-used free
    entries are evicted first.  Leased bytes are bounded separately by
    ``ring`` x live keys, and are dropped from tracking (never freed under
    the caller) by :meth:`evict` / :meth:`close`.
    """

    def __init__(self, capacity_bytes: int = 256 << 20, ring: int = 2,
                 name: str = "arena"):
        if ring < 1:
            raise ValueError(f"arena ring must be >= 1, got {ring}")
        self.capacity_bytes = int(capacity_bytes)
        self.ring = int(ring)
        self.name = name
        self._lock = threading.Lock()
        self._by_key: Dict[Tuple, List[_Entry]] = {}
        self._clock = 0
        self._stats = ArenaStats()
        self._closed = False

    # -- internal ----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _free_bytes_locked(self) -> int:
        return sum(e.cap for ents in self._by_key.values()
                   for e in ents if not e.leased)

    def _evict_lru_free_locked(self) -> None:
        """Drop LRU free entries until the free pool fits capacity_bytes."""
        over = self._free_bytes_locked() - self.capacity_bytes
        while over > 0:
            lru: Optional[_Entry] = None
            for ents in self._by_key.values():
                for e in ents:
                    if not e.leased and (lru is None or e.stamp < lru.stamp):
                        lru = e
            if lru is None:
                return
            self._by_key[lru.key].remove(lru)
            if not self._by_key[lru.key]:
                del self._by_key[lru.key]
            self._stats.evictions += 1
            over -= lru.cap

    def _steal_bucket_locked(self, cap: int) -> Optional[_Entry]:
        """LRU free entry of the same size class, re-keyed to the caller."""
        lru: Optional[_Entry] = None
        for ents in self._by_key.values():
            for e in ents:
                fits = not e.leased and e.cap == cap
                if fits and (lru is None or e.stamp < lru.stamp):
                    lru = e
        if lru is None:
            return None
        self._by_key[lru.key].remove(lru)
        if not self._by_key[lru.key]:
            del self._by_key[lru.key]
        return lru

    # -- public ------------------------------------------------------------
    def acquire(self, program: str, device: str, shape, dtype) -> BufferLease:
        """Lease a (shape, dtype) buffer for ``(program, device)``.

        Resolution order: free ring entry under the exact key (hit) ->
        recycle the oldest leased ring entry if the ring is full (the
        double-buffer overwrite) -> re-key an LRU free entry of the same
        size bucket -> allocate (miss).
        """
        key = arena_key(program, device, shape, dtype)
        itemsize = np.dtype(dtype).itemsize
        nbytes = int(np.prod(key[2], dtype=np.int64)) * itemsize
        cap = bucket_bytes(nbytes)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"arena {self.name!r} is closed")
            self._stats.acquires += 1
            ents = self._by_key.setdefault(key, [])
            entry = None
            for e in ents:
                if not e.leased:
                    entry = e
                    self._stats.hits += 1
                    break
            if entry is None and len(ents) >= self.ring:
                # ring full, all leased: overwrite the oldest lease
                entry = min(ents, key=lambda e: e.stamp)
                self._stats.recycles += 1
            if entry is None:
                stolen = self._steal_bucket_locked(cap)
                if stolen is not None:
                    stolen.key = key
                    ents.append(stolen)
                    entry = stolen
                    self._stats.rekeys += 1
                else:
                    entry = _Entry(key, cap, 0)
                    ents.append(entry)
                    self._stats.misses += 1
            entry.leased = True
            entry.stamp = self._tick()
            self._evict_lru_free_locked()
            view = entry.raw[:nbytes].view(np.dtype(dtype)).reshape(key[2])
            return BufferLease(key, view, entry)

    def release(self, lease: BufferLease) -> None:
        """Return a lease to the free pool (optional -- the ring recycles
        unreleased leases; releasing early just widens reuse)."""
        with self._lock:
            e = lease._entry
            ents = self._by_key.get(e.key)
            if ents is None or e not in ents or not e.leased:
                return  # evicted/closed/double-release: nothing to do
            e.leased = False
            e.stamp = self._tick()
            self._evict_lru_free_locked()

    def register(self, program: str, device: str, shape, dtype,
                 count: Optional[int] = None) -> None:
        """Pre-populate a key's ring with ``count`` free entries (default:
        the full ring) so the first warm submit already hits."""
        key = arena_key(program, device, shape, dtype)
        itemsize = np.dtype(dtype).itemsize
        nbytes = int(np.prod(key[2], dtype=np.int64)) * itemsize
        cap = bucket_bytes(nbytes)
        n = self.ring if count is None else int(count)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"arena {self.name!r} is closed")
            ents = self._by_key.setdefault(key, [])
            while len(ents) < min(n, self.ring):
                ents.append(_Entry(key, cap, self._tick()))
            self._evict_lru_free_locked()

    def evict(self, program: str) -> int:
        """Drop every entry keyed to ``program`` (all devices/shapes).
        Leased arrays stay valid for their holders; the arena just stops
        tracking them.  Returns the number of entries dropped."""
        with self._lock:
            victims = [k for k in self._by_key if k[0] == program]
            n = 0
            for k in victims:
                n += len(self._by_key.pop(k))
            self._stats.evictions += n
            return n

    def evict_prefix(self, prefix: str) -> int:
        """Drop every entry whose program key starts with ``prefix`` (a
        tenant partition closing: all its programs, all devices/shapes).
        Same holder semantics as :meth:`evict`."""
        with self._lock:
            victims = [k for k in self._by_key if k[0].startswith(prefix)]
            n = 0
            for k in victims:
                n += len(self._by_key.pop(k))
            self._stats.evictions += n
            return n

    def trim_prefix(self, prefix: str, cap_bytes: int) -> int:
        """Evict LRU *free* entries under ``prefix`` until that prefix's
        free bytes fit ``cap_bytes`` (the per-tenant LRU cap of an
        :class:`ArenaPartition`).  Leased entries are never touched — a
        tenant over its cap keeps its in-flight buffers and simply loses
        reuse.  Returns the number of entries evicted."""
        dropped = 0
        with self._lock:
            while True:
                free = [
                    e
                    for k, ents in self._by_key.items()
                    if k[0].startswith(prefix)
                    for e in ents
                    if not e.leased
                ]
                if sum(e.cap for e in free) <= cap_bytes:
                    return dropped
                lru = min(free, key=lambda e: e.stamp)
                self._by_key[lru.key].remove(lru)
                if not self._by_key[lru.key]:
                    del self._by_key[lru.key]
                self._stats.evictions += 1
                dropped += 1

    def stats_for_prefix(self, prefix: str) -> ArenaStats:
        """Gauges (entries / leases / bytes) restricted to keys under
        ``prefix``.  The monotonic counters stay arena-global (acquire
        resolution crosses partitions via bucket steals), so they are
        reported as zero here — read :attr:`stats` for them."""
        with self._lock:
            s = ArenaStats()
            for k, ents in self._by_key.items():
                if not k[0].startswith(prefix):
                    continue
                for e in ents:
                    s.entries += 1
                    if e.leased:
                        s.leases_out += 1
                        s.bytes_leased += e.cap
                    else:
                        s.bytes_pooled += e.cap
            return s

    def close(self) -> int:
        """Release everything and refuse further acquires.  Returns the
        number of entries dropped (leased holders keep their arrays)."""
        with self._lock:
            n = sum(len(v) for v in self._by_key.values())
            self._stats.evictions += n
            self._by_key.clear()
            self._closed = True
            return n

    @property
    def stats(self) -> ArenaStats:
        with self._lock:
            s = ArenaStats(**{f: getattr(self._stats, f) for f in
                              ("acquires", "hits", "rekeys", "misses",
                               "recycles", "evictions")})
            for ents in self._by_key.values():
                for e in ents:
                    s.entries += 1
                    if e.leased:
                        s.leases_out += 1
                        s.bytes_leased += e.cap
                    else:
                        s.bytes_pooled += e.cap
            return s

    def __repr__(self) -> str:
        s = self.stats
        return (f"BufferArena({self.name!r}, entries={s.entries}, "
                f"pooled={s.bytes_pooled}B, leased={s.bytes_leased}B, "
                f"hit%={100 * s.hits / max(1, s.acquires):.0f})")


# --------------------------------------------------------------------------
# Arena partitions (multi-tenant)
# --------------------------------------------------------------------------


class ArenaPartition:
    """A tenant's slice of a shared :class:`BufferArena`.

    Every program key is namespaced as ``"<tenant>::<program>"``, so two
    tenants registering the same workload name never alias ring entries.
    ``cap_bytes`` (optional) bounds the partition's *free* bytes with its
    own LRU trim on top of the arena-global capacity -- a noisy tenant
    cannot squat the whole pool with cold buffers.  Closing the partition
    evicts only the tenant's keys; the shared arena stays open for
    co-tenants.  Exposes the same acquire/release/register/evict surface
    the runtime expects from a session arena.
    """

    def __init__(self, arena: BufferArena, tenant: str,
                 cap_bytes: Optional[int] = None):
        self.arena = arena
        self.tenant = str(tenant)
        self.cap_bytes = None if cap_bytes is None else int(cap_bytes)
        self._prefix = self.tenant + "::"
        self._closed = False

    def scoped(self, program: str) -> str:
        return self._prefix + program

    def _trim(self) -> None:
        if self.cap_bytes is not None:
            self.arena.trim_prefix(self._prefix, self.cap_bytes)

    # -- BufferArena surface ------------------------------------------------
    def acquire(self, program: str, device: str, shape, dtype) -> BufferLease:
        if self._closed:
            raise RuntimeError(
                f"arena partition {self.tenant!r} is closed")
        lease = self.arena.acquire(self.scoped(program), device, shape, dtype)
        self._trim()
        return lease

    def release(self, lease: BufferLease) -> None:
        self.arena.release(lease)
        self._trim()

    def register(self, program: str, device: str, shape, dtype,
                 count: Optional[int] = None) -> None:
        if self._closed:
            raise RuntimeError(
                f"arena partition {self.tenant!r} is closed")
        self.arena.register(self.scoped(program), device, shape, dtype,
                            count=count)
        self._trim()

    def evict(self, program: str) -> int:
        return self.arena.evict(self.scoped(program))

    def close(self) -> int:
        """Drop this tenant's entries only; the shared arena stays open."""
        self._closed = True
        return self.arena.evict_prefix(self._prefix)

    @property
    def stats(self) -> ArenaStats:
        return self.arena.stats_for_prefix(self._prefix)

    def __repr__(self) -> str:
        s = self.stats
        return (f"ArenaPartition({self.tenant!r}, entries={s.entries}, "
                f"pooled={s.bytes_pooled}B, leased={s.bytes_leased}B)")


# --------------------------------------------------------------------------
# Transfer pipeline
# --------------------------------------------------------------------------


class StageFuture:
    """Tiny future for a prefetched stage-in (WorkerPool has no futures)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _set(self, value: Any, error: Optional[BaseException]) -> None:
        self._value = value
        self._error = error
        self._event.set()

    def result(self) -> Any:
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._value


class TransferPipeline:
    """Per-run double-buffered staging coordinator.

    ``prefetch(fn)`` runs a stage-in on a pooled thread and returns a
    :class:`StageFuture` -- issued for packet *k+1* while packet *k*
    computes, so the device thread's next dispatch is already staged.
    ``stage_out(fn, nbytes)`` hands a commit (device->host conversion +
    in-place write) to the single committer thread; commits are FIFO,
    overlapped with subsequent computes.  ``flush()`` blocks until every
    commit landed; ``close()`` stops the committer.

    **Adaptive handoff:** a thread handoff costs a wakeup (tens to
    hundreds of microseconds on an oversubscribed host), so overlapping
    only pays above a staging-size crossover -- the same economics as a
    DMA engine.  Commits smaller than ``async_threshold_bytes`` run
    inline on the calling thread; larger ones go to the committer.

    ``h2d_busy_s`` / ``d2h_busy_s`` accumulate the staging work the
    pipeline handled (observability; the run's *phase* windows are
    stamped by its PhaseClock).
    """

    # hand-picked crossover for the reference container; sessions inject a
    # calibrated value (``async_threshold_bytes=`` / ``tuned=``) per host
    DEFAULT_ASYNC_THRESHOLD_BYTES = 256 << 10

    def __init__(self, pool, async_threshold_bytes: Optional[int] = None):
        if async_threshold_bytes is None:
            async_threshold_bytes = self.DEFAULT_ASYNC_THRESHOLD_BYTES
        if int(async_threshold_bytes) < 0:
            raise ValueError(f"async_threshold_bytes must be >= 0, "
                             f"got {async_threshold_bytes}")
        self._pool = pool            # WorkerPool-like: submit(fn) -> Event
        self.async_threshold_bytes = int(async_threshold_bytes)
        self._cv = threading.Condition()
        self._jobs: deque = deque()
        self._closed = False
        self._draining = 0           # commits currently executing
        self._done_event: Optional[threading.Event] = None
        self._time_lock = threading.Lock()
        self.h2d_busy_s = 0.0
        self.d2h_busy_s = 0.0
        self.commits = 0
        self.prefetches = 0

    # -- stage-in ----------------------------------------------------------
    def prefetch(self, fn: Callable[[], Any]) -> StageFuture:
        fut = StageFuture()

        def run():
            t0 = time.perf_counter()
            try:
                fut._set(fn(), None)
            except BaseException as e:  # surfaced at fut.result()
                fut._set(None, e)
            with self._time_lock:
                self.h2d_busy_s += time.perf_counter() - t0
                self.prefetches += 1

        self._pool.submit(run)
        return fut

    def note_h2d(self, seconds: float) -> None:
        """Credit inline stage-in work (the unprefetched first packet)."""
        with self._time_lock:
            self.h2d_busy_s += seconds

    # -- stage-out ---------------------------------------------------------
    def start(self) -> None:
        self._done_event = self._pool.submit(self._commit_loop)

    def stage_out(self, fn: Callable[[], None],
                  nbytes: Optional[int] = None) -> None:
        """Commit a packet result.  Small commits (below the async
        threshold) run inline -- a thread wakeup would cost more than the
        copy it hides; large ones overlap on the committer thread."""
        if nbytes is not None and nbytes < self.async_threshold_bytes:
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                with self._time_lock:
                    self.d2h_busy_s += time.perf_counter() - t0
                    self.commits += 1
            return
        with self._cv:
            if self._closed:
                raise RuntimeError("TransferPipeline is closed")
            self._jobs.append(fn)
            self._cv.notify_all()

    def _commit_loop(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._cv.wait()
                if not self._jobs:
                    return  # closed and drained
                fn = self._jobs.popleft()
                self._draining += 1
            t0 = time.perf_counter()
            try:
                fn()  # commit closures handle their own errors
            finally:
                with self._time_lock:
                    self.d2h_busy_s += time.perf_counter() - t0
                    self.commits += 1
                with self._cv:
                    self._draining -= 1
                    self._cv.notify_all()

    def flush(self) -> None:
        """Block until the commit queue is empty and the committer idle."""
        with self._cv:
            while self._jobs or self._draining:
                self._cv.wait()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._done_event is not None:
            self._done_event.wait()
