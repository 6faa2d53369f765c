"""Elastic autoscaling: replicas join and leave the fleet under load.

The router's queue-delay estimate (aggregate outstanding work over
aggregate ready power) is the one signal: a *sustained* breach of the
delay target scales up (activating a standby replica, which becomes
placeable only after its warm-up — joining is not free), a sustained idle
period scales down.  Flapping is penalized through the warm-up cost
account: a joined replica may not leave until it has been resident long
enough to amortize ``payback x warmup_s`` of the capacity its warm-up
burned, and every action starts a cooldown during which the autoscaler
holds still.  The decision layer is execution-agnostic — the discrete
fleet simulator and the threaded fleet server both drive ``step()`` and
apply its events through the session membership hooks
(``add_device`` / ``remove_device``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.fleet.placement import ReplicaState


@dataclass
class AutoscaleConfig:
    target_delay_s: float = 0.25       # router queue-delay SLO
    breach_s: float = 0.2              # sustained breach before scale-up
    idle_delay_s: float = 0.02         # delay below this counts as idle
    idle_s: float = 0.75               # sustained idle before scale-down
    warmup_s: float = 0.15             # join warm-up (not placeable yet)
    cooldown_s: float = 0.4            # min gap between scale actions
    # flap penalty: a joined replica must stay resident at least
    # payback * warmup_s (+ cooldown) before it may be scaled down, so a
    # join always amortizes the capacity its warm-up burned
    payback: float = 4.0
    min_replicas: int = 1
    max_replicas: Optional[int] = None

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if (self.max_replicas is not None
                and self.max_replicas < self.min_replicas):
            raise ValueError("max_replicas must be >= min_replicas")


@dataclass
class ScaleEvent:
    t: float
    action: str                        # "up" | "down"
    replica: str
    queue_delay_s: float               # the signal at decision time
    reason: str


class ElasticAutoscaler:
    """Queue-delay-driven membership controller over ReplicaStates.

    Pure decision logic: ``step(now, states)`` flips ``active``/``warm_at``
    on the states it scales and returns the event (or None).  Whoever owns
    real resources (the threaded fleet server) subscribes to events and
    mirrors them onto sessions via the membership hooks.
    """

    def __init__(self, cfg: Optional[AutoscaleConfig] = None, **kw):
        self.cfg = cfg if cfg is not None else AutoscaleConfig(**kw)
        self.events: List[ScaleEvent] = []
        self.warmup_cost_s = 0.0       # total warm-up capacity burned
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action_t = -math.inf
        self._last_up_t = -math.inf

    # -- signal --------------------------------------------------------------
    @staticmethod
    def queue_delay(now: float, states: Sequence[ReplicaState]) -> float:
        """Fleet queue delay: aggregate outstanding work over aggregate
        READY power (a warming replica contributes nothing yet)."""
        ready = [s for s in states if s.ready(now)]
        if not ready:
            return math.inf
        power = sum(s.power for s in ready)
        work = sum(s.resid for s in ready)
        return work / max(power, 1e-12)

    # -- control loop --------------------------------------------------------
    def step(self, now: float,
             states: Sequence[ReplicaState]) -> Optional[ScaleEvent]:
        cfg = self.cfg
        delay = self.queue_delay(now, states)
        active = [s for s in states if s.active]
        if delay > cfg.target_delay_s:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            if (now - self._breach_since >= cfg.breach_s
                    and now - self._last_action_t >= cfg.cooldown_s
                    and (cfg.max_replicas is None
                         or len(active) < cfg.max_replicas)):
                standby = [s for s in states if not s.active]
                if standby:
                    return self._scale_up(now, standby, delay)
        elif delay < cfg.idle_delay_s:
            self._breach_since = None
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= cfg.idle_s
                    and now - self._last_action_t >= cfg.cooldown_s
                    and len(active) > cfg.min_replicas):
                return self._scale_down(now, active, delay)
        else:
            # neither breaching nor idle: both dwell clocks reset — only
            # SUSTAINED signals act, transient blips never flap the fleet
            self._breach_since = None
            self._idle_since = None
        return None

    def _scale_up(self, now: float, standby: List[ReplicaState],
                  delay: float) -> ScaleEvent:
        # most powerful standby first: one join should clear the breach
        s = max(standby, key=lambda s: (s.power0, s.name))
        s.active = True
        s.warm_at = now + self.cfg.warmup_s
        s.joined_at = now
        s.last_t = now
        s.resid = 0.0
        self.warmup_cost_s += self.cfg.warmup_s
        self._last_up_t = now
        ev = ScaleEvent(t=now, action="up", replica=s.name,
                        queue_delay_s=delay,
                        reason=f"queue delay {delay:.3f}s > target "
                               f"{self.cfg.target_delay_s:.3f}s for "
                               f">= {self.cfg.breach_s:.3f}s")
        self._record(ev, now)
        return ev

    def _scale_down(self, now: float, active: List[ReplicaState],
                    delay: float) -> Optional[ScaleEvent]:
        cfg = self.cfg
        min_residency = cfg.payback * cfg.warmup_s + cfg.cooldown_s
        if now - self._last_up_t < min_residency:
            # fleet-wide flap guard: the latest join must amortize its
            # warm-up before ANY replica may leave — shrinking a fleet
            # that just paid to grow is the flap being penalized
            return None
        # only replicas that amortized their join may leave; prefer the
        # emptiest, then the weakest, then the youngest
        candidates = [s for s in active
                      if now - s.joined_at >= min_residency]
        if not candidates:
            return None
        s = min(candidates, key=lambda s: (s.resid, s.power0, s.name))
        s.active = False
        ev = ScaleEvent(t=now, action="down", replica=s.name,
                        queue_delay_s=delay,
                        reason=f"queue delay {delay:.3f}s < idle "
                               f"{cfg.idle_delay_s:.3f}s for "
                               f">= {cfg.idle_s:.3f}s")
        self._record(ev, now)
        return ev

    def _record(self, ev: ScaleEvent, now: float) -> None:
        self.events.append(ev)
        self._last_action_t = now
        self._breach_since = None
        self._idle_since = None

    # -- accounting ----------------------------------------------------------
    def flaps(self) -> int:
        """Direction reversals faster than the guards should allow: an up
        undone by a down before its warm-up amortized, or a down undone
        by an up faster than a genuine new breach could dwell.  A healthy
        controller reports 0 — the residency/cooldown/dwell guards make
        these structurally impossible, and this measures that claim."""
        cfg = self.cfg
        up_down = cfg.payback * cfg.warmup_s + cfg.cooldown_s
        down_up = max(cfg.cooldown_s, cfg.breach_s)
        n = 0
        for a, b in zip(self.events, self.events[1:]):
            if a.action == "up" and b.action == "down" \
                    and b.t - a.t < up_down:
                n += 1
            if a.action == "down" and b.action == "up" \
                    and b.t - a.t < down_up:
                n += 1
        return n

    def summary(self) -> dict:
        return {
            "events": [(e.t, e.action, e.replica) for e in self.events],
            "ups": sum(1 for e in self.events if e.action == "up"),
            "downs": sum(1 for e in self.events if e.action == "down"),
            "flaps": self.flaps(),
            "warmup_cost_s": self.warmup_cost_s,
        }
