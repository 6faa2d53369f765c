"""Sweep the knobs in the calibrated simulator; confirm winners on metal.

The search space is exactly the set of hand-frozen constants the prior
PRs shipped: packet granularity (``n_packets``), the dim-0 panel ``lws``,
the lease growth law (``lease_overhead_frac`` / ``lease_k_max``), and the
transfer crossover.  A full sweep on hardware would cost minutes per
kernel; in the calibrated discrete-event simulator it costs milliseconds,
so the grid runs there, and only the top candidates (plus the defaults —
the winner must never regress them) graduate to an interleaved-median
shoot-out on the real engine.

The transfer crossover never needs simulating: it falls analytically out
of the calibration (``calibrate.crossover_bytes``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import SchedulerBase
from repro_torch.core.simulate import simulate
from repro_torch.tune.cache import Calibration, TunedConfig
from repro_torch.tune.calibrate import crossover_bytes, sim_config, sim_devices
from repro_torch.tune.timing import interleaved_medians

# default grids: small enough to sweep in milliseconds, wide enough to
# bracket every hand-picked constant (which are all included — the
# search can therefore never do worse than the defaults it replaces)
N_PACKETS_GRID = (4, 8, 16, 32, 64, 128, 256)
LEASE_FRAC_GRID = (0.01, SchedulerBase.lease_overhead_frac, 0.05, 0.1)
LEASE_K_MAX_GRID = (8, 16, SchedulerBase.lease_k_max, 256)
DEFAULT_N_PACKETS = 128          # DynamicScheduler's hand-picked default
PREDICT_SEEDS = 3


@dataclass
class SearchResult:
    winner: TunedConfig
    default: TunedConfig                      # the hand-picked baseline
    predictions: List[Tuple[Dict, float]] = field(default_factory=list)

    @property
    def predicted_gain_pct(self) -> float:
        if not self.default.predicted_s:
            return 0.0
        return 100.0 * (1.0 - self.winner.predicted_s
                        / self.default.predicted_s)


def predict(cal: Calibration, kernel: str, total_work: int, lws: int, *,
            scheduler: str = "dynamic",
            n_packets: Optional[int] = None,
            lease_overhead_frac: Optional[float] = None,
            lease_k_max: Optional[int] = None,
            seeds: int = PREDICT_SEEDS) -> float:
    """Mean simulated co-execution time for one candidate, over a fixed
    seed set (identical for every candidate: comparisons are exact)."""
    devs = sim_devices(cal, kernel)
    skw = {"n_packets": n_packets} if n_packets is not None else {}
    total = 0.0
    for seed in range(seeds):
        cfg = sim_config(cal, scheduler=scheduler, scheduler_kwargs=skw,
                         lease_overhead_frac=lease_overhead_frac,
                         lease_k_max=lease_k_max, seed=seed)
        total += simulate(total_work, lws, devs, cfg).total_time
    return total / seeds


def search(cal: Calibration, kernel: str, total_work: int, lws: int, *,
           scheduler: str = "dynamic",
           n_packets_grid: Sequence[int] = N_PACKETS_GRID,
           lws_grid: Optional[Sequence[int]] = None,
           lease_frac_grid: Sequence[float] = LEASE_FRAC_GRID,
           lease_k_max_grid: Sequence[int] = LEASE_K_MAX_GRID,
           seeds: int = PREDICT_SEEDS,
           fingerprint: Optional[str] = None) -> SearchResult:
    """Two-stage grid sweep in the calibrated simulator.

    Stage 1 sweeps granularity (``n_packets`` x ``lws``) under default
    lease constants; stage 2 sweeps the lease growth law at the stage-1
    optimum.  The default configuration is always part of stage 1, and
    the final winner is re-compared against it on the same seeds — the
    result's ``winner.predicted_s <= default.predicted_s`` invariant is
    structural, not statistical.
    """
    lws_grid = list(lws_grid) if lws_grid else [lws]
    np_grid = list(dict.fromkeys(list(n_packets_grid)
                                 + [DEFAULT_N_PACKETS]))
    predictions: List[Tuple[Dict, float]] = []

    # stage 1: granularity
    best = None
    for w in lws_grid:
        for n in np_grid:
            t = predict(cal, kernel, total_work, w, scheduler=scheduler,
                        n_packets=n, seeds=seeds)
            predictions.append(({"n_packets": n, "lws": w}, t))
            if best is None or t < best[2]:
                best = (n, w, t)
    best_n, best_w, best_t = best

    # stage 2: lease growth law at the stage-1 optimum
    best_lease: Tuple[Optional[float], Optional[int]] = (None, None)
    for frac in lease_frac_grid:
        for k_max in lease_k_max_grid:
            t = predict(cal, kernel, total_work, best_w,
                        scheduler=scheduler, n_packets=best_n,
                        lease_overhead_frac=frac, lease_k_max=k_max,
                        seeds=seeds)
            predictions.append(({"n_packets": best_n, "lws": best_w,
                                 "lease_overhead_frac": frac,
                                 "lease_k_max": k_max}, t))
            if t < best_t:
                best_t, best_lease = t, (frac, k_max)

    default_t = predict(cal, kernel, total_work, lws, scheduler=scheduler,
                        n_packets=DEFAULT_N_PACKETS, seeds=seeds)
    threshold = crossover_bytes(cal.transfer_base_s,
                                cal.transfer_s_per_byte, cal.wake_cost_s)
    default = TunedConfig(
        kernel=kernel, fingerprint=fingerprint, scheduler=scheduler,
        scheduler_kwargs={"n_packets": DEFAULT_N_PACKETS}, lws=lws,
        predicted_s=default_t, predicted_default_s=default_t)
    if best_t >= default_t:
        # structural guarantee: the defaults are in the space, so a sweep
        # that can't beat them returns them (never-worse by construction)
        winner = default
    else:
        winner = TunedConfig(
            kernel=kernel, fingerprint=fingerprint, scheduler=scheduler,
            scheduler_kwargs={"n_packets": best_n}, lws=best_w,
            lease_overhead_s=cal.sched_overhead_s,
            lease_overhead_frac=best_lease[0],
            lease_k_max=best_lease[1],
            async_threshold_bytes=threshold,
            predicted_s=best_t, predicted_default_s=default_t)
    return SearchResult(winner=winner, default=default,
                        predictions=predictions)


def confirm_on_hardware(configs: Sequence[TunedConfig],
                        run_fn: Callable[[TunedConfig], object], *,
                        rounds: int = 5) -> Tuple[int, Dict[int, float]]:
    """Interleaved-median shoot-out between candidate configs on the
    real engine.  ``run_fn(cfg)`` executes ONE run under ``cfg``; the
    shared protocol handles rotation and medians.  Returns the winning
    index and the per-candidate medians."""
    idx = list(range(len(configs)))
    med = interleaved_medians(idx, lambda i: run_fn(configs[i]), rounds)
    best = min(idx, key=lambda i: med[i])
    return best, med
