"""Evaluation metrics (paper §IV).

* balance      = T_FD / T_LD (first-finisher / last-finisher busy time); 1.0
                 means all devices finished together.
* S_max        = sum_i(T_i) / max_i(T_i) where T_i = single-device response
                 time of the whole problem on device i.
* speedup      = T_fastest_single / T_coexec  (baseline: fastest device,
                 i.e. the GPU in the paper).
* efficiency   = speedup / S_max.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.energy.meter import EnergyReport


@dataclass(frozen=True)
class PhaseBreakdown:
    """Per-phase wall-clock of one run (the paper's two timing modes made
    measurable instead of inferred):

    * ``init_s``      — setup: executable builds (or cache hits) overlapped
                        with scheduler preparation, buffer registration.
    * ``h2d_s``       — host-to-device staging: the initial stage-in wave
                        (scheduler pull + launch binding + input staging)
                        before the first packet computes.
    * ``roi_s``       — the ROI window: packet dispatch + compute, first
                        carve to queue drained (== ``RunResult.total_time``).
    * ``d2h_s``       — device-to-host staging: the commit tail after the
                        queue drains (result conversion + assembly still
                        in flight on the transfer pipeline).
    * ``offload_s``   — the offload window: ``h2d_s + roi_s + d2h_s`` (the
                        full data path to and from the devices).
    * ``teardown_s``  — releasing per-run state; for BINARY-mode submits
                        also the cache/buffer eviction.

    In the threaded engine the five windows are disjoint wall segments, so
    ``init_s + h2d_s + roi_s + d2h_s + teardown_s == binary`` exactly and
    ``offload_s == h2d_s + roi_s + d2h_s``.  The simulator keeps transfer
    costs inside its event timeline (``offload_s == roi_s``) and reports
    ``h2d_s`` / ``d2h_s`` as the *unhidden* transfer components charged to
    that timeline — under ``BufferPolicy.POOLED`` the double-buffered
    pipeline hides per-packet staging behind compute, shrinking them.

    ``binary = init_s + offload_s + teardown_s`` is the paper's binary-mode
    response time; ``roi_s`` alone is its ROI-mode response time.
    """
    init_s: float = 0.0
    offload_s: float = 0.0
    roi_s: float = 0.0
    teardown_s: float = 0.0
    h2d_s: float = 0.0
    d2h_s: float = 0.0

    @property
    def binary(self) -> float:
        return self.init_s + self.offload_s + self.teardown_s

    @property
    def staging(self) -> float:
        """The transfer (staging) time on the run's critical path."""
        return self.h2d_s + self.d2h_s

    @property
    def management(self) -> float:
        """Everything that is not the ROI window (the paper's 'management
        overheads')."""
        return self.binary - self.roi_s


@dataclass
class RunResult:
    """Timing record of one co-execution run."""
    total_time: float                   # response time (ROI unless noted)
    device_busy: List[float]            # per-device busy time
    device_finish: List[float]          # per-device finish timestamp
    packets: List                       # executed packets (scheduler.Packet)
    binary_time: Optional[float] = None  # incl. init/teardown ("binary" mode)
    aborted_devices: int = 0
    retries: int = 0                    # packets re-issued after a requeue
    phases: Optional[PhaseBreakdown] = None  # per-phase wall-clock
    # per-device time blocked on the scheduler hand-off (lock waits +
    # carves + steals); empty when the engine predates the lease API
    sched_wait_s: List[float] = field(default_factory=list)
    # joule accounting (repro_torch.energy): per-device busy/idle/lock/transfer
    # energy integrated from the phase windows by the executor's
    # EnergyMeter.  None only when an executor predates the energy
    # subsystem; joule-blind (zero PowerModel) runs report total_j == 0.
    energy: Optional[EnergyReport] = None

    @property
    def energy_j(self) -> float:
        """Total joules of this run (0.0 for joule-blind models)."""
        return self.energy.total_j if self.energy is not None else 0.0

    def __post_init__(self):
        if not self.retries:
            self.retries = sum(1 for p in self.packets
                               if getattr(p, "retried", False))


def balance(result: RunResult) -> float:
    fin = [t for t in result.device_finish if t > 0]
    if len(fin) <= 1:
        return 1.0
    return min(fin) / max(fin)


def s_max_from_times(single_times: Sequence[float]) -> float:
    """Max achievable speedup vs the fastest device.  With device powers
    p_i = 1/T_i a perfect proportional split finishes in 1/sum(p_i), so
    S_max = sum(p_i)/p_fastest.  (The paper prints sum(T_i)/max(T_i), which
    equals this only in the homogeneous case; we use the physical formula —
    for the paper's testbed the two differ by <10% and do not change any
    ranking.)"""
    powers = [1.0 / t for t in single_times]
    return sum(powers) / max(powers)


def speedup(fastest_single: float, coexec_time: float) -> float:
    return fastest_single / coexec_time


def efficiency(fastest_single: float, coexec_time: float,
               single_times: Sequence[float]) -> float:
    return (speedup(fastest_single, coexec_time)
            / s_max_from_times(single_times))


def geomean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return 0.0
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def inflection_point(problem_sizes: Sequence[float],
                     coexec_times: Sequence[float],
                     single_times: Sequence[float]) -> Optional[float]:
    """Smallest problem size where co-execution beats the fastest single
    device (paper Fig. 6's vertical lines), linearly interpolated."""
    for i in range(len(problem_sizes)):
        if coexec_times[i] < single_times[i]:
            if i == 0:
                return float(problem_sizes[0])
            # interpolate crossing between i-1 and i
            d_prev = coexec_times[i - 1] - single_times[i - 1]
            d_cur = coexec_times[i] - single_times[i]
            t = d_prev / (d_prev - d_cur) if d_prev != d_cur else 1.0
            return float(problem_sizes[i - 1]
                         + t * (problem_sizes[i] - problem_sizes[i - 1]))
    return None
