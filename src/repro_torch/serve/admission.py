"""EDF admission with shed/degrade: one policy object, every admitter.

Extracted verbatim from ``CoexecServer._admit`` so the *same* decision
procedure runs at every level of the stack:

* the replica server (``CoexecServer``) admits its local dispatch round
  with it (``unit_work=True`` — the threaded server prices every request
  at one work-group, matching the requests/s scale of its EWMA powers);
* the fleet router (the JAX package's ``fleet.FleetRouter``; its port is
  a later slice) admits against the
  *aggregate* fleet capacity and residual before placement — shedding is
  decided at the router, not the replica;
* the discrete-event serving simulator accepts one as an injection hook
  (``simulate_serving(..., admission=...)``) so fleet co-simulation and
  the threaded paths cannot drift apart.

The procedure (EDF-within-round):

1. sort pending by (deadline, rid) — earliest deadline first;
2. cap the round at ~one *round quantum* of fleet work (iteration-level
   scheduling: the leftover stays queued so re-sorting / re-prediction
   happens every quantum, not once per backlog);
3. predict each request's completion from the aggregate power estimate
   (plus any residual in-flight work) and shed — or degrade, granting
   proportionally fewer decode tokens — requests predicted to miss, so
   doomed work cannot drag every later request past its deadline too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class AdmissionConfig:
    policy: str = "shed"             # "shed" | "degrade" | "none"
    gen: int = 16                    # full decode-token grant per request
    min_gen: int = 1                 # floor for degraded requests
    round_quantum_s: float = math.inf  # max EDF-first work per round
    # True: every request is one unit of work regardless of Request.size
    # (the threaded server's requests/s accounting); False: use .size
    # (the simulator's / router's work-group accounting)
    unit_work: bool = False

    def __post_init__(self):
        if self.policy not in ("shed", "degrade", "none"):
            raise ValueError(f"admission policy must be 'shed', 'degrade' "
                             f"or 'none', got {self.policy!r}")


class EdfAdmission:
    """Reusable EDF admission + shed/degrade decision procedure.

    Stateless between calls: everything it needs arrives as arguments, so
    one instance can serve any number of rounds, servers or routers.
    """

    def __init__(self, cfg: Optional[AdmissionConfig] = None, **kw):
        self.cfg = cfg if cfg is not None else AdmissionConfig(**kw)

    def admit(self, pending: List, now: float, *,
              total_power: float,
              residual_wg: float = 0.0,
              calibrated: bool = True,
              completed: Optional[List] = None
              ) -> Tuple[List, List]:
        """EDF-order ``pending``; shed/degrade predicted misses in place.

        Returns ``(admitted, leftover)`` — the leftover (beyond the round
        quantum) stays queued for the next round.  ``total_power`` is the
        admitting scope's aggregate capacity (a replica's EWMA powers, or
        the fleet's); ``residual_wg`` is in-flight work already committed
        ahead of this round (the router's outstanding-work estimate —
        without it the predictor only sees THIS round's queue and admits
        doomed requests under backlog).  ``calibrated=False`` disables
        prediction entirely (everything admits) until at least one round
        of measured powers exists.  Shed requests are flagged in place;
        when ``completed`` is given they are also moved there with
        ``finish=None`` (the threaded server's bookkeeping).
        """
        cfg = self.cfg
        pending.sort(key=lambda r: (r.deadline, r.rid))
        for r in pending:
            r.gen_alloc = cfg.gen
        do_filter = calibrated and cfg.policy != "none"
        cap = (total_power * cfg.round_quantum_s if total_power > 0
               else math.inf)
        admitted: List = []
        leftover: List = []
        cum = 0.0
        for r in pending:
            w = 1.0 if cfg.unit_work else float(r.size)
            if admitted and cum + w > cap:
                leftover.append(r)
                continue
            cum += w
            if not do_filter or total_power <= 0:
                admitted.append(r)
                continue
            pred_finish = now + (residual_wg + cum) / total_power
            if pred_finish <= r.deadline:
                admitted.append(r)
                continue
            if cfg.policy == "degrade":
                # degrade never drops: scale the generation budget to the
                # remaining slack, down to min_gen for already-late work
                slack = r.deadline - now
                frac = (slack / (pred_finish - now)
                        if slack > 0 else 0.0)
                r.gen_alloc = max(cfg.min_gen, int(cfg.gen * frac))
                r.degraded = r.gen_alloc < cfg.gen
                admitted.append(r)
            else:
                r.shed = True
                if completed is not None:
                    r.finish = None
                    completed.append(r)
                cum -= w                # shed work frees the queue behind it
        return admitted, leftover

    def __repr__(self) -> str:
        return f"EdfAdmission({self.cfg!r})"


def sequence_total(requests: Sequence, unit_work: bool) -> float:
    """Total admission-scale work of ``requests`` under a work model."""
    if unit_work:
        return float(len(requests))
    return float(sum(r.size for r in requests))
