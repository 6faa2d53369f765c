"""Calibrated autotuner: close the hand-tuning loop.

    measure (microbench) -> fit (calibrate) -> search (simulate)
        -> confirm (hardware) -> cache (per device fingerprint)

Every constant the runtime hand-picked —
packet granularity, panel lws, the lease growth law, the 256 KiB
transfer crossover — is measured, fitted, swept, and persisted here.
``autotune()`` drives the whole loop; ``EngineSession(tuned=...)`` /
``coexec(tuned=...)`` apply the result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.device import DeviceGroup
from repro_torch.core.runtime import Program
from repro_torch.tune.cache import (Calibration, DeviceCalibration,
                                    TuneCache, TunedConfig,
                                    device_fingerprint, resolve_tuned)
from repro_torch.tune.calibrate import calibrate, crossover_bytes
from repro_torch.tune.microbench import Measurements, measure
from repro_torch.tune.search import (SearchResult, confirm_on_hardware,
                                     search)

__all__ = [
    "Calibration", "DeviceCalibration", "Measurements", "SearchResult",
    "TuneCache", "TunedConfig", "TuneReport", "autotune", "calibrate",
    "confirm_on_hardware", "crossover_bytes", "device_fingerprint",
    "measure", "resolve_tuned", "search",
]


@dataclass
class TuneReport:
    """What one ``autotune()`` call actually did — the cache-reuse
    acceptance check reads ``microbenches_run == 0`` on a warm run."""
    config: TunedConfig
    fingerprint: str
    cache_hit_winner: bool = False
    cache_hit_calibration: bool = False
    microbenches_run: int = 0
    confirmed: bool = False


def autotune(devices: Sequence[DeviceGroup],
             programs: Dict[str, Program],
             kernel: str, *,
             cache: Optional[object] = None,
             rounds: int = 7,
             scheduler: str = "dynamic",
             n_packets_grid: Optional[Sequence[int]] = None,
             lws_grid: Optional[Sequence[int]] = None,
             confirm_run: Optional[
                 Callable[[TunedConfig], object]] = None,
             confirm_top: int = 2,
             confirm_rounds: int = 5,
             measure_fn: Optional[Callable] = None) -> TuneReport:
    """The full loop for one kernel on one fleet, cache-first.

    * winner cached for this fleet fingerprint -> return it untouched
      (zero micro-benchmarks, identical TunedConfig);
    * calibration cached -> skip measuring, go straight to the search;
    * otherwise measure every program in ``programs`` once (the
      calibration is shared by later kernels on this fleet), fit, sweep.

    ``confirm_run(cfg)`` (optional) executes one hardware run under a
    candidate config; the top ``confirm_top`` simulated candidates plus
    the defaults then compete in an interleaved-median shoot-out and the
    *measured* winner is cached.  ``measure_fn`` substitutes the
    measurement pass (tests inject synthetic measurements).

    ``cache`` is a :class:`TuneCache`, a path, or None (default path).
    """
    if kernel not in programs:
        raise KeyError(f"kernel {kernel!r} not in programs "
                       f"({sorted(programs)})")
    if not isinstance(cache, TuneCache):
        cache = TuneCache(cache)
    fp = device_fingerprint(devices)

    cached = cache.get_winner(fp, kernel)
    if cached is not None:
        return TuneReport(config=cached, fingerprint=fp,
                          cache_hit_winner=True)

    cal = cache.get_calibration(fp)
    hit_cal = cal is not None and kernel in cal.kernels
    report = TuneReport(config=None, fingerprint=fp,  # type: ignore
                        cache_hit_calibration=hit_cal)
    if not hit_cal:
        m = (measure_fn or measure)(devices, programs, rounds=rounds)
        report.microbenches_run = m.n_timed_runs
        fresh = calibrate(m)
        if cal is not None:
            # keep other kernels' fits; host terms take the fresh values
            for k, v in cal.kernels.items():
                fresh.kernels.setdefault(k, v)
        cal = fresh
        cache.put_calibration(fp, cal)

    prog = programs[kernel]
    kw = {}
    if n_packets_grid is not None:
        kw["n_packets_grid"] = n_packets_grid
    res = search(cal, kernel, prog.total_work, prog.lws,
                 scheduler=scheduler, lws_grid=lws_grid,
                 fingerprint=fp, **kw)
    winner = res.winner

    if confirm_run is not None:
        # hardware has the last word: defaults + top simulated candidates
        ranked = sorted({id(c): c for c in (winner, res.default)}.values(),
                        key=lambda c: c.predicted_s or 0.0)
        pool = ranked[:max(1, confirm_top)]
        if res.default not in pool:
            pool.append(res.default)
        best, med = confirm_on_hardware(pool, confirm_run,
                                        rounds=confirm_rounds)
        winner = pool[best]
        winner.confirmed_s = med[best]
        report.confirmed = True

    report.config = winner
    cache.put_winner(fp, kernel, winner)
    return report
