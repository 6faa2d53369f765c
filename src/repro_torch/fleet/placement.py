"""Placement policies: which replica serves each request.

The fleet router's analogue of the scheduler registry — policies are
plain classes registered by name (``register_placement``), constructed by
``make_placement``, and the router consults exactly one per request:

    place(request, now, states) -> replica index, or None to SHED

Only deadline-aware policies ever return None; shedding is a *router*
decision (the replica never second-guesses it).  ``ReplicaState`` is the
router's per-replica book: a declared (offline) power, an online EWMA
power, and an EWMA of outstanding work that drains analytically at the
service rate between measurements — the same estimate-then-measure shape
as the schedulers' HGuided power adaptation, one rung up.

Built-ins:

* ``round_robin``     — cycle the ready replicas (the naivest baseline).
* ``static``          — deterministic weighted round-robin over DECLARED
  powers (largest-remainder credits).  Never adapts; this is the "best
  static single-replica assignment" family the benchmark must beat.
* ``power_prop``      — the same credit scheme over the *online* EWMA
  powers: adapts to measured capacity, blind to queue depth.
* ``least_residual``  — join-shortest-queue, weighted: place on the
  replica with the smallest predicted queue delay (EWMA outstanding work
  over EWMA power).
* ``deadline``        — EDF-aware least-finish-time: place on the ready
  replica predicted to *finish this request soonest*; if no replica can
  make the deadline, shed at the router so doomed work never displaces
  feasible work queued behind it.
* ``energy``          — joule-aware deadline placement: among the replicas
  predicted to MAKE the deadline, place on the one with the lowest
  measured J/work-group (the ``j_wg`` EWMA fed back by the driver);
  replicas without energy feedback yet, or infeasible requests, fall back
  to the ``deadline`` behavior — so with joule-blind replicas the two
  policies are identical.
"""
from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence


@dataclass
class ReplicaState:
    """The router's book on one replica.

    ``power0`` is the declared (offline-profiled) capacity in wg/s;
    ``power`` is the online EWMA the router refines from measured replica
    feedback; ``resid`` is the EWMA of outstanding (placed, unfinished)
    work, drained analytically at the service rate between updates.
    ``active``/``warm_at`` are the autoscaler's membership bits: a
    scaled-up replica is placeable only once its warm-up has elapsed.
    """
    name: str
    power0: float                          # declared capacity, wg/s
    power: float = 0.0                     # online EWMA capacity
    resid: float = 0.0                     # EWMA outstanding work, wg
    active: bool = True
    warm_at: float = 0.0                   # placeable from this time
    joined_at: float = 0.0                 # last activation time
    last_t: float = 0.0                    # residual drain clock
    placed: int = 0                        # requests routed here
    shed_for: int = 0                      # sheds attributed at placement
    # measured joules per work-group (EWMA from driver feedback); 0.0
    # means "no energy feedback yet" — energy placement then treats the
    # replica as cost-unknown and falls back to finish-time ordering
    j_wg: float = 0.0

    def __post_init__(self):
        if self.power <= 0.0:
            self.power = self.power0

    def drain(self, now: float) -> None:
        """Outstanding work drains at the service rate between updates."""
        if now > self.last_t:
            self.resid = max(0.0,
                             self.resid - (now - self.last_t) * self.power)
            self.last_t = now

    def ready(self, now: float) -> bool:
        return self.active and now >= self.warm_at

    def queue_delay(self, now: float) -> float:
        """Predicted wait before a request placed now starts draining."""
        return self.resid / max(self.power, 1e-12)

    def pred_finish(self, now: float, size: float) -> float:
        """Predicted completion of a size-``size`` request placed now."""
        return now + (self.resid + size) / max(self.power, 1e-12)

    def pred_joules(self, size: float) -> float:
        """Predicted energy of a size-``size`` request here (0.0 while
        the replica has no energy feedback)."""
        return size * self.j_wg


class PlacementPolicy:
    """Base contract: stateless between fleets, stateful within one."""

    def place(self, req, now: float,
              states: Sequence[ReplicaState]) -> Optional[int]:
        """Index into ``states`` for ``req``, or None to shed at the
        router.  Implementations must only pick ``ready(now)`` replicas;
        ``_ready`` provides the candidate list (never empty while any
        replica is active — a warming fleet falls back to active ones)."""
        raise NotImplementedError

    @staticmethod
    def _ready(now: float, states: Sequence[ReplicaState]) -> List[int]:
        ready = [i for i, s in enumerate(states) if s.ready(now)]
        if ready:
            return ready
        # every active replica still warming: the fleet must not drop on
        # the floor — queue onto the active set (it will be warm by then)
        return [i for i, s in enumerate(states) if s.active] or \
            list(range(len(states)))


class RoundRobinPlacement(PlacementPolicy):
    """Cycle the ready replicas, capacity-blind."""

    def __init__(self):
        self._i = 0

    def place(self, req, now, states):
        ready = self._ready(now, states)
        pick = ready[self._i % len(ready)]
        self._i += 1
        return pick


class _WeightedCredit(PlacementPolicy):
    """Deterministic weighted round-robin by largest-remainder credits:
    every placement grants each candidate ``w_i / sum(w)`` credit and
    spends one credit on the argmax — long-run shares converge to the
    weights with no randomness (bit-identical replays)."""

    def _weight(self, s: ReplicaState) -> float:
        raise NotImplementedError

    def __init__(self):
        self._credit: Dict[str, float] = {}

    def place(self, req, now, states):
        ready = self._ready(now, states)
        weights = {i: max(self._weight(states[i]), 1e-12) for i in ready}
        total = sum(weights.values())
        for i in ready:
            self._credit[states[i].name] = \
                self._credit.get(states[i].name, 0.0) + weights[i] / total
        pick = max(ready, key=lambda i: (self._credit[states[i].name], -i))
        self._credit[states[pick].name] -= 1.0
        return pick


class StaticPlacement(_WeightedCredit):
    """Weighted by DECLARED powers only — the no-feedback baseline.

    This is the strongest member of the "static single-replica
    assignment" family: each request is deterministically pinned to one
    replica in proportion to the offline capacity profile, exactly like a
    Static scheduler chunk split.  It pays for profile bias, stragglers
    and queue imbalance the same way Static does in the paper.
    """

    def _weight(self, s):
        return s.power0


class PowerPropPlacement(_WeightedCredit):
    """Weighted by the ONLINE EWMA powers: adapts to measured capacity
    (a straggling replica's share decays), but stays queue-blind."""

    def _weight(self, s):
        return s.power


class LeastResidualPlacement(PlacementPolicy):
    """Weighted join-shortest-queue: smallest predicted queue delay wins
    (EWMA outstanding work over EWMA power; ties break to the faster
    replica, then the lowest index for determinism)."""

    def place(self, req, now, states):
        ready = self._ready(now, states)
        return min(ready, key=lambda i: (states[i].queue_delay(now),
                                         -states[i].power, i))


class DeadlinePlacement(PlacementPolicy):
    """EDF-aware earliest-finish placement with router-level shedding.

    Each candidate's completion is predicted from its EWMA residual and
    power; the request goes to the soonest predicted finisher.  If even
    that finisher would miss the deadline (by more than ``slack_margin``
    seconds of grace), the request is shed AT THE ROUTER: admitting it
    anywhere would burn fleet capacity on a doomed request and drag the
    feasible work queued behind it past its deadlines too — the paper's
    time-constrained argument, applied to placement.
    """

    def __init__(self, shed: bool = True, slack_margin: float = 0.0):
        self.shed = shed
        self.slack_margin = slack_margin

    def place(self, req, now, states):
        ready = self._ready(now, states)
        size = float(getattr(req, "size", 1))
        pick = min(ready, key=lambda i: (states[i].pred_finish(now, size),
                                         -states[i].power, i))
        if (self.shed and states[pick].pred_finish(now, size)
                > req.deadline + self.slack_margin):
            states[pick].shed_for += 1
            return None
        return pick


class EnergyPlacement(DeadlinePlacement):
    """Joule-aware deadline placement: cheapest feasible replica wins.

    The candidate set is restricted to replicas predicted to make the
    request's deadline (plus ``slack_margin`` grace); among those the
    request goes to the lowest predicted J/request (measured ``j_wg``
    EWMA × size), ties to the earliest finisher.  Cold start is a
    deterministic one-shot probe: a feasible replica with no energy
    feedback AND no traffic yet gets the request, so every replica's
    J/wg is measured before steady-state routing settles — without the
    probe an idle efficient replica would never be discovered.  When NO
    replica is feasible, behavior degrades to :class:`DeadlinePlacement`
    exactly: shed at the router (``shed=True``) or place on the earliest
    predicted finisher.  With joule-blind fleets every ``j_wg`` stays 0
    and — after each replica's single probe placement, which
    finish-order ties to the deadline pick anyway — the policy matches
    ``deadline``.
    """

    def place(self, req, now, states):
        ready = self._ready(now, states)
        size = float(getattr(req, "size", 1))
        feasible = [i for i in ready
                    if states[i].pred_finish(now, size)
                    <= req.deadline + self.slack_margin]
        if not feasible:
            return super().place(req, now, states)
        unprobed = [i for i in feasible
                    if states[i].j_wg <= 0 and states[i].placed == 0]
        if unprobed:
            return min(unprobed,
                       key=lambda i: (states[i].pred_finish(now, size), i))
        measured = [i for i in feasible if states[i].j_wg > 0]
        if measured:
            return min(measured,
                       key=lambda i: (states[i].pred_joules(size),
                                      states[i].pred_finish(now, size), i))
        return min(feasible, key=lambda i: (states[i].pred_finish(now, size),
                                            -states[i].power, i))


# -- registry (mirrors core/scheduler.py's scheduler registry) ---------------

@dataclass
class PlacementSpec:
    cls: type
    defaults: Dict[str, object] = field(default_factory=dict)


_REGISTRY: Dict[str, PlacementSpec] = {}

# Back-compat-style view: name -> zero-config constructor, kept in
# lockstep with _REGISTRY exactly like core.scheduler.SCHEDULERS.
PLACEMENTS: Dict[str, Callable[..., PlacementPolicy]] = {}


def register_placement(name: str, cls: type, *,
                       defaults: Optional[Mapping[str, object]] = None,
                       overwrite: bool = False) -> type:
    """Register a placement policy under ``name`` (the fleet's Tier-3
    plugin hook — same contract shape as ``register_scheduler``)."""
    if not (isinstance(cls, type) and issubclass(cls, PlacementPolicy)):
        raise TypeError(f"placement {name!r} must be a PlacementPolicy "
                        f"subclass, got {cls!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"placement {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = PlacementSpec(cls, dict(defaults or {}))
    _REGISTRY[name] = spec
    PLACEMENTS[name] = cls if not spec.defaults else \
        functools.partial(cls, **spec.defaults)
    return cls


def unregister_placement(name: str) -> None:
    _REGISTRY.pop(name, None)
    PLACEMENTS.pop(name, None)


def available_placements() -> List[str]:
    return sorted(_REGISTRY)


def placement_spec(name: str) -> PlacementSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown placement {name!r}; registered: "
                       f"{available_placements()}") from None


def placement_accepts(name: str, param: str) -> bool:
    """True if ``name``'s constructor takes ``param`` (capability probe,
    mirroring ``scheduler_accepts``)."""
    for klass in placement_spec(name).cls.__mro__:
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


def make_placement(name: str, **kw) -> PlacementPolicy:
    spec = placement_spec(name)
    merged = {**spec.defaults, **kw}
    return spec.cls(**merged)


register_placement("round_robin", RoundRobinPlacement)
register_placement("static", StaticPlacement)
register_placement("power_prop", PowerPropPlacement)
register_placement("least_residual", LeastResidualPlacement)
register_placement("deadline", DeadlinePlacement)
register_placement("energy", EnergyPlacement)
