"""Serving metrics: latency percentiles, SLO attainment, goodput.

One accounting path shared by the threaded CoexecServer and the
discrete-event simulator (core/simulate.simulate_serving): both fill the
same ``Request`` fields, both are summarized here.

* p50/p99 latency — over *served* requests only (shed requests have no
  latency; they show up in attainment and shed_frac instead).
* SLO attainment — fraction of ALL offered requests that finished by
  their deadline.  Shedding a request can never raise attainment; it can
  only protect the attainment of the others.
* goodput — work-groups of on-time service delivered per second; late
  and shed work counts for nothing (the paper's time-constrained lens).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from repro_torch.serve.workload import Request


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile, q in [0, 100]."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1 - frac) + s[hi] * frac


@dataclass
class ServeStats:
    n_requests: int
    served: int                      # finished (on time or late)
    shed: int                        # dropped by admission control
    missed: int                      # finished but past deadline
    degraded: int                    # served with reduced generation
    p50_latency: float
    p99_latency: float
    mean_latency: float
    slo_attainment: float            # on-time / offered
    goodput_wg_s: float              # on-time work-groups per second
    throughput_wg_s: float           # all served work-groups per second
    duration: float
    dispatch: Dict[str, int] = field(default_factory=dict)
    # joule accounting (repro_torch.energy): total energy the serving window
    # burned; 0.0 for joule-blind power models or engines that predate
    # the energy subsystem
    energy_j: float = 0.0

    @property
    def j_per_request(self) -> float:
        """Energy per served request (0.0 when nothing was served or the
        fleet is joule-blind)."""
        return self.energy_j / self.served if self.served else 0.0

    def row(self) -> str:
        row = (f"p50={self.p50_latency:.3f}s p99={self.p99_latency:.3f}s "
               f"slo={self.slo_attainment:.3f} "
               f"goodput={self.goodput_wg_s:.1f}wg/s "
               f"shed={self.shed}/{self.n_requests} missed={self.missed}")
        if self.energy_j > 0:
            row += (f" energy={self.energy_j:.1f}J "
                    f"({self.j_per_request:.2f}J/req)")
        return row


def summarize(requests: Sequence[Request], *,
              duration: Optional[float] = None,
              dispatch: Optional[Dict[str, int]] = None,
              energy_j: float = 0.0) -> ServeStats:
    n = len(requests)
    served = [r for r in requests if not r.shed and r.finish is not None]
    lats = [r.latency for r in served]
    on_time = [r for r in served if r.met_slo]
    if duration is None:
        fins = [r.finish for r in served]
        t0 = min((r.arrival for r in requests), default=0.0)
        duration = (max(fins) - t0) if fins else 0.0
    dur = max(duration, 1e-12)
    return ServeStats(
        n_requests=n,
        served=len(served),
        shed=sum(1 for r in requests if r.shed),
        missed=len(served) - len(on_time),
        degraded=sum(1 for r in served if r.degraded),
        p50_latency=percentile(lats, 50),
        p99_latency=percentile(lats, 99),
        mean_latency=sum(lats) / len(lats) if lats else float("nan"),
        slo_attainment=len(on_time) / n if n else 0.0,
        goodput_wg_s=sum(r.size for r in on_time) / dur,
        throughput_wg_s=sum(r.size for r in served) / dur,
        duration=duration,
        dispatch=dict(dispatch or {}),
        energy_j=energy_j,
    )
