"""Open-loop serving workloads: requests, deadlines, arrival processes.

The closed-loop toy loop ("serve one fixed batch, as fast as possible")
hides exactly the effect the paper studies: under *time-constrained*
scenarios the per-offload management overheads and load imbalance turn
into deadline misses.  An open-loop workload decouples arrivals from
completions — requests keep arriving whether or not the system keeps up —
which is how serving systems are actually driven (and how overload
becomes visible as shed/missed requests instead of silently stretched
makespans).

Three arrival processes:

* ``poisson_arrivals``  — memoryless baseline at a given rate.
* ``bursty_arrivals``   — on/off modulated Poisson (mean rate preserved):
  exponential ON phases at ``burst``× the base rate, OFF phases at
  ``off_frac``× — the diurnal-spike shape that stresses admission.
* ``trace_arrivals``    — replay explicit timestamps (production traces).

Plus trace **record/replay** (``record_trace`` / ``TraceWorkload``): any
measured run — threaded server, simulator, fleet router — can be written
to JSONL (arrival, size, deadline, plus the measured finish/shed/replica
accounting) and replayed *bit-identically* as a fresh workload, so "heavy
traffic" comparisons run every policy against the exact same schedule.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    """One serving request: a unit of open-loop work with a deadline.

    ``size`` is the request's service demand in scheduler work-groups
    (1 for a plain decode request; >1 models long prompts / long
    generations in the simulator).  The dispatch engine fills the
    accounting fields.
    """
    rid: int
    arrival: float                       # seconds since workload start
    deadline: float                      # absolute seconds
    size: int = 1
    prompt: Optional[np.ndarray] = None  # token ids (threaded mode)
    # -- accounting, written by CoexecServer / simulate_serving ------------
    finish: Optional[float] = None
    shed: bool = False
    degraded: bool = False
    gen_alloc: Optional[int] = None      # granted decode tokens (degrade)
    replica: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def met_slo(self) -> bool:
        return (not self.shed and self.finish is not None
                and self.finish <= self.deadline)


def poisson_arrivals(n: int, rate: float,
                     rng: np.random.Generator) -> List[float]:
    """n arrival times of a Poisson process at ``rate`` req/s."""
    assert rate > 0
    gaps = rng.exponential(1.0 / rate, size=n)
    return list(np.cumsum(gaps))


def bursty_arrivals(n: int, rate: float, rng: np.random.Generator, *,
                    burst: float = 4.0, off_frac: float = 0.2,
                    mean_phase_s: float = 0.5) -> List[float]:
    """On/off modulated Poisson with time-average rate ≈ ``rate``.

    ON phases run at ``burst * rate``, OFF phases at ``off_frac * rate``;
    phase durations are exponential with mean ``mean_phase_s``, and the
    ON-time fraction is chosen so the long-run average recovers ``rate``.
    """
    assert burst > 1.0 and 0.0 <= off_frac < 1.0
    rate_hi, rate_lo = burst * rate, off_frac * rate
    frac_on = (rate - rate_lo) / (rate_hi - rate_lo)
    out: List[float] = []
    t = 0.0
    on = rng.random() < frac_on
    while len(out) < n:
        # phase length: mean_phase_s split so E[on]/E[cycle] == frac_on
        mean = mean_phase_s * (frac_on if on else (1 - frac_on)) * 2
        dur = rng.exponential(max(mean, 1e-6))
        r = rate_hi if on else rate_lo
        if r > 0:
            tt = t + rng.exponential(1.0 / r)
            while tt < t + dur and len(out) < n:
                out.append(tt)
                tt += rng.exponential(1.0 / r)
        t += dur
        on = not on
    return out[:n]


def trace_arrivals(times: Sequence[float]) -> List[float]:
    """Replay explicit arrival timestamps (must be non-decreasing)."""
    out = [float(t) for t in times]
    if any(b < a for a, b in zip(out, out[1:])):
        raise ValueError("trace arrivals must be non-decreasing")
    return out


ARRIVALS = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
}


def make_requests(arrivals: Sequence[float], slo: float, *,
                  size: int = 1,
                  prompt_fn: Optional[Callable[[int], np.ndarray]] = None,
                  ) -> List[Request]:
    """Attach deadlines (arrival + slo) and optional prompts."""
    reqs = []
    for i, a in enumerate(arrivals):
        reqs.append(Request(rid=i, arrival=float(a),
                            deadline=float(a) + slo, size=size,
                            prompt=None if prompt_fn is None
                            else prompt_fn(i)))
    return reqs


# -- trace record / replay ---------------------------------------------------
# One JSONL record per request.  The workload half (rid/arrival/deadline/
# size) is what replay rebuilds; the outcome half (finish/shed/degraded/
# replica) makes the trace a measurement artifact too — "heavy traffic"
# claims point at a file, not a vibe.
TRACE_VERSION = 1


def _trace_record(r: Request) -> dict:
    return {
        "rid": r.rid,
        "arrival": r.arrival,
        "deadline": r.deadline,
        "size": r.size,
        "finish": r.finish,
        "shed": r.shed,
        "degraded": r.degraded,
        "replica": r.replica,
    }


def record_trace(outcome, path: str) -> int:
    """Write a workload run to ``path`` as JSONL; returns records written.

    ``outcome`` is anything carrying the requests: a ``ServeOutcome`` /
    ``FleetSimResult`` (``.requests``) or a plain sequence of Requests.
    Records are written in (arrival, rid) order — the replay order — with
    a leading header line carrying the trace version.
    """
    reqs = getattr(outcome, "requests", outcome)
    reqs = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    with open(path, "w") as f:
        f.write(json.dumps({"trace_version": TRACE_VERSION,
                            "n_requests": len(reqs)}) + "\n")
        for r in reqs:
            f.write(json.dumps(_trace_record(r)) + "\n")
    return len(reqs)


class TraceWorkload:
    """A recorded workload, replayable bit-identically.

    ``requests()`` rebuilds *fresh* Request objects — identical rid /
    arrival / deadline / size schedule, accounting fields cleared — so the
    same trace can be replayed through any router policy or server and
    the outcomes compared on equal footing.  The recorded outcome half is
    kept on ``records`` for analysis (e.g. comparing a replay against the
    measured original).
    """

    def __init__(self, records: Sequence[dict]):
        recs = sorted(records, key=lambda d: (d["arrival"], d["rid"]))
        for a, b in zip(recs, recs[1:]):
            if b["arrival"] < a["arrival"]:
                raise ValueError("trace arrivals must be non-decreasing")
        self.records: List[dict] = [dict(d) for d in recs]

    @classmethod
    def load(cls, path: str) -> "TraceWorkload":
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if "trace_version" in d:      # header line
                    if d["trace_version"] != TRACE_VERSION:
                        raise ValueError(
                            f"unsupported trace version "
                            f"{d['trace_version']} (have {TRACE_VERSION})")
                    continue
                records.append(d)
        return cls(records)

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "TraceWorkload":
        return cls([_trace_record(r) for r in requests])

    def requests(self, *,
                 prompt_fn: Optional[Callable[[int], np.ndarray]] = None
                 ) -> List[Request]:
        """Fresh Request objects replaying the recorded schedule exactly.

        Prompts are not serialized (token arrays don't belong in a trace
        file); ``prompt_fn(rid)`` reattaches them for threaded replays.
        """
        return [Request(rid=d["rid"], arrival=float(d["arrival"]),
                        deadline=float(d["deadline"]), size=int(d["size"]),
                        prompt=None if prompt_fn is None
                        else prompt_fn(d["rid"]))
                for d in self.records]

    def queue(self, **kw) -> "RequestQueue":
        return RequestQueue(self.requests(**kw))

    def arrivals(self) -> List[float]:
        return [d["arrival"] for d in self.records]

    def __len__(self) -> int:
        return len(self.records)

    def __repr__(self) -> str:
        span = (self.records[-1]["arrival"] - self.records[0]["arrival"]
                if self.records else 0.0)
        return (f"TraceWorkload({len(self.records)} requests over "
                f"{span:.3f}s)")


class RequestQueue:
    """Time-ordered open-loop request source.

    The admission loop polls it with the current clock; requests become
    visible only once their arrival time has passed (open loop: the queue
    never waits for the server).
    """

    def __init__(self, requests: Sequence[Request]):
        self._reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._arrivals = [r.arrival for r in self._reqs]
        self._i = 0

    def poll(self, now: float) -> List[Request]:
        """Requests that have arrived since the last poll."""
        j = bisect.bisect_right(self._arrivals, now)
        out = self._reqs[self._i:j]
        self._i = j
        return out

    def next_arrival(self) -> Optional[float]:
        if self._i >= len(self._reqs):
            return None
        return self._arrivals[self._i]

    def preview(self) -> Optional[Request]:
        """First unreleased request, without consuming it (warmup shapes)."""
        if self._i >= len(self._reqs):
            return None
        return self._reqs[self._i]

    def remaining(self) -> int:
        return len(self._reqs) - self._i

    def __len__(self) -> int:
        return len(self._reqs)
