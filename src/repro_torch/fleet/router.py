"""FleetRouter: deadline-aware placement over N replica sessions.

One rung up from ``CoexecServer``: where the server schedules *packets*
across devices inside one session, the router places *requests* across
whole replica sessions — and the paper's argument recurs at this level
too.  Placement and admission decisions amortize across many replicas
only if the management layer stays cheap and adapts online; a static
assignment pays for profile bias and stragglers with tail latency exactly
like a Static scheduler chunk split.

The router is execution-agnostic: it owns the per-replica book
(``ReplicaState``), the placement policy (registered like a scheduler),
the shared EDF admission (serve/admission.py — shedding is decided HERE,
not at the replica) and the optional elastic autoscaler.  Drivers feed it
arrivals and measurements:

* the discrete-event fleet simulator (``fleet/sim.py``) drives it against
  ``simulate_serving``-modeled replicas at 1000-replica scale;
* the threaded fleet server (``fleet/worker.py``) drives it against real
  ``EngineSession``-backed replica workers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.autoscale import ElasticAutoscaler, ScaleEvent
from repro_torch.fleet.placement import (PlacementPolicy, ReplicaState,
                                         make_placement)
from repro_torch.serve.admission import AdmissionConfig, EdfAdmission


@dataclass
class RouterConfig:
    placement: str = "deadline"
    placement_kwargs: Dict = field(default_factory=dict)
    # admission policy at the router ("shed" | "none"): EDF order +
    # quantum + fleet-infeasibility shedding BEFORE placement.  Per-replica
    # infeasibility shedding is the deadline placement policy's call.
    admit: str = "shed"
    admit_quantum_s: float = math.inf
    # EWMA smoothing for measured replica feedback (power and residual);
    # same role as ServerConfig.ewma one rung down
    ewma: float = 0.5


@dataclass
class Placed:
    """One routing decision: where a request went (or why it didn't)."""
    request: object
    replica: Optional[int]               # index into router.states; None=shed
    pred_finish: Optional[float] = None  # router's prediction at placement


class FleetRouter:
    """Deadline-aware request placement over an elastic replica fleet."""

    def __init__(self, replicas: Sequence[Tuple[str, float]],
                 cfg: Optional[RouterConfig] = None, *,
                 autoscaler: Optional[ElasticAutoscaler] = None,
                 standby: Sequence[str] = (),
                 on_scale: Optional[Callable[[ScaleEvent], None]] = None):
        """``replicas``: (name, declared_power_wg_s) pairs.  Names listed
        in ``standby`` start inactive — autoscaler spares that join on a
        sustained queue-delay breach.  ``on_scale`` is the resource hook:
        the threaded server mirrors events onto worker sessions with the
        ``add_device``/``remove_device`` membership hooks."""
        self.cfg = cfg or RouterConfig()
        if self.cfg.admit not in ("shed", "none"):
            raise ValueError(f"router admit must be 'shed' or 'none', "
                             f"got {self.cfg.admit!r}")
        names = [n for n, _ in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        unknown = set(standby) - set(names)
        if unknown:
            raise ValueError(f"standby names not in fleet: {sorted(unknown)}")
        self.states: List[ReplicaState] = [
            ReplicaState(name=n, power0=p, active=n not in standby)
            for n, p in replicas]
        self.placement: PlacementPolicy = make_placement(
            self.cfg.placement, **self.cfg.placement_kwargs)
        self.admission = EdfAdmission(AdmissionConfig(
            policy=self.cfg.admit, round_quantum_s=self.cfg.admit_quantum_s,
            unit_work=False))
        self.autoscaler = autoscaler
        self.on_scale = on_scale
        self.shed: List = []               # requests shed at the router
        self.predicted: Dict[int, float] = {}   # rid -> predicted finish
        self.scale_events: List[ScaleEvent] = []

    # -- bookkeeping ---------------------------------------------------------
    def index_of(self, name: str) -> int:
        for i, s in enumerate(self.states):
            if s.name == name:
                return i
        raise KeyError(name)

    def ready_indices(self, now: float) -> List[int]:
        return [i for i, s in enumerate(self.states) if s.ready(now)]

    def fleet_power(self, now: float) -> float:
        return sum(self.states[i].power for i in self.ready_indices(now))

    def fleet_residual(self, now: float) -> float:
        return sum(self.states[i].resid for i in self.ready_indices(now))

    def queue_delay(self, now: float) -> float:
        return self.fleet_residual(now) / max(self.fleet_power(now), 1e-12)

    # -- the routing step ----------------------------------------------------
    def route(self, pending: List, now: float
              ) -> Tuple[List[Placed], List]:
        """Admit + place every routable request in ``pending``.

        Returns ``(placements, leftover)``: one :class:`Placed` per
        admitted request (``replica=None`` means shed — either the shared
        EDF admission predicted fleet-wide infeasibility, or the deadline
        placement found no replica that makes the deadline), and the
        leftover beyond the admission quantum, which stays queued for the
        caller's next poll.  Residuals drain to ``now`` first; the
        autoscaler (if any) steps on the fresh signal before placement.
        """
        for s in self.states:
            s.drain(now)
        if self.autoscaler is not None:
            ev = self.autoscaler.step(now, self.states)
            if ev is not None:
                self.scale_events.append(ev)
                if self.on_scale is not None:
                    self.on_scale(ev)
        shed_mark = len(self.shed)
        admitted, leftover = self.admission.admit(
            pending, now,
            total_power=self.fleet_power(now),
            residual_wg=self.fleet_residual(now),
            calibrated=True,
            completed=self.shed)
        out: List[Placed] = []
        for r in self.shed[shed_mark:]:    # admission-shed (fleet-infeasible)
            out.append(Placed(request=r, replica=None))
        for r in admitted:
            idx = self.placement.place(r, now, self.states)
            if idx is None:        # placement-shed (no feasible replica)
                r.shed = True
                self.shed.append(r)
                out.append(Placed(request=r, replica=None))
                continue
            s = self.states[idx]
            pred = s.pred_finish(now, float(r.size))
            s.resid += float(r.size)
            s.placed += 1
            self.predicted[r.rid] = pred
            out.append(Placed(request=r, replica=idx, pred_finish=pred))
        return out, leftover

    # -- measurement feedback ------------------------------------------------
    def feedback(self, idx: int, now: float, *,
                 measured_power: Optional[float] = None,
                 measured_resid: Optional[float] = None,
                 measured_j_wg: Optional[float] = None) -> None:
        """Blend a replica's measured capacity / outstanding work /
        energy cost into the router's EWMA book (the driver calls this
        per round or epoch).  ``measured_j_wg`` is the replica's joules
        per work-group — the ``energy`` placement's routing signal."""
        a = self.cfg.ewma
        s = self.states[idx]
        s.drain(now)
        if measured_power is not None and measured_power > 0:
            s.power = a * measured_power + (1 - a) * s.power
        if measured_resid is not None:
            s.resid = a * max(measured_resid, 0.0) + (1 - a) * s.resid
        if measured_j_wg is not None and measured_j_wg > 0:
            s.j_wg = measured_j_wg if s.j_wg <= 0 else \
                a * measured_j_wg + (1 - a) * s.j_wg

    def summary(self) -> dict:
        d = {
            "placement": self.cfg.placement,
            "placed": {s.name: s.placed for s in self.states},
            "shed_at_router": len(self.shed),
            "scale": (self.autoscaler.summary()
                      if self.autoscaler is not None else None),
        }
        return d

    def __repr__(self) -> str:
        active = sum(1 for s in self.states if s.active)
        return (f"FleetRouter({self.cfg.placement!r}, "
                f"{active}/{len(self.states)} replicas active, "
                f"shed={len(self.shed)})")
