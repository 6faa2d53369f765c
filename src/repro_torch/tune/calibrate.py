"""Fit the simulator's cost terms from raw micro-benchmark medians.

The discrete-event simulator (core/simulate.py) prices a packet as
``launch_overhead + rows / throughput`` plus host hand-off and transfer
terms.  This module turns
:class:`repro_torch.tune.microbench.Measurements`
into exactly those terms:

* per (kernel, device): a least-squares line through the row-span sweep
  — slope is ``1/throughput``, intercept the per-packet fixed cost
  (``SimDevice.packet_cost``'s busy components);
* host: the measured lock-crossing cost becomes ``sched_overhead_s``,
  the event-wake cost ``host_cost_per_packet``;
* transfers: a line through the copy-size sweep gives byte-traffic
  terms, and its intersection with the wake cost is the *crossover* —
  the smallest commit worth handing to the async committer
  (``TransferPipeline.async_threshold_bytes``).

``bytes_per_wg`` bridges the static side: a Program's input and output
byte counts seed ``SimDevice.xfer_bytes_per_wg`` without running
anything.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.runtime import Program
from repro_torch.core.simulate import SimConfig, SimDevice
from repro_torch.tune.cache import Calibration, DeviceCalibration
from repro_torch.tune.microbench import Measurements


def fit_line(samples: Dict[int, float]) -> Tuple[float, float]:
    """Least-squares ``(intercept, slope)`` through {x: seconds}.

    With a single point the intercept is 0 (pure rate); degenerate or
    noise-dominated fits are clamped to non-negative intercept and
    positive slope so downstream throughputs stay finite.
    """
    xs = sorted(samples)
    if not xs:
        raise ValueError("fit_line needs at least one sample")
    if len(xs) == 1:
        x = xs[0]
        return 0.0, max(samples[x], 1e-12) / max(x, 1)
    n = float(len(xs))
    mx = sum(xs) / n
    my = sum(samples[x] for x in xs) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (samples[x] - my) for x in xs)
    slope = sxy / sxx if sxx > 0 else 0.0
    if slope <= 0:
        # noise ate the slope: fall back to the biggest sample's rate
        x = xs[-1]
        return 0.0, max(samples[x], 1e-12) / max(x, 1)
    intercept = max(0.0, my - slope * mx)
    return intercept, slope


def fit_device(samples: Dict[int, float]) -> DeviceCalibration:
    """One (kernel, device) fit: seconds-per-row line -> rate + overhead."""
    intercept, slope = fit_line(samples)
    return DeviceCalibration(throughput=1.0 / slope, overhead_s=intercept)


def crossover_bytes(transfer_base_s: float, transfer_s_per_byte: float,
                    wake_cost_s: float, *,
                    default: int = 256 << 10) -> int:
    """Smallest commit size where an async hand-off beats an inline copy.

    The committer hand-off costs one thread wake; an inline copy costs
    ``base + nbytes/bw``.  Below the intersection the calling thread
    should just copy (``TransferPipeline`` runs it inline); above it the
    wake is amortized.  Degenerate fits keep the hand-picked default;
    a wake cheaper than even the fixed copy cost means "always async"
    (threshold 0).
    """
    if transfer_s_per_byte <= 0:
        return int(default)
    if wake_cost_s <= transfer_base_s:
        return 0
    x = (wake_cost_s - transfer_base_s) / transfer_s_per_byte
    return max(0, int(x))


def calibrate(m: Measurements) -> Calibration:
    """Fit every cost term from one measurement pass."""
    cal = Calibration(
        sched_overhead_s=max(m.crossing_s, 1e-7),
        wake_cost_s=max(m.wake_s, 1e-7),
    )
    if m.copy_s:
        base, per_byte = fit_line(m.copy_s)
        cal.transfer_base_s = base
        cal.transfer_s_per_byte = per_byte
    for kernel, per_dev in m.kernels.items():
        cal.kernels[kernel] = {name: fit_device(samples)
                               for name, samples in per_dev.items()}
    return cal


# -- simulator construction ------------------------------------------------

def sim_devices(cal: Calibration, kernel: str) -> Sequence[SimDevice]:
    """Calibrated :class:`SimDevice` fleet for one kernel's search."""
    if kernel not in cal.kernels:
        raise KeyError(f"no calibration for kernel {kernel!r} "
                       f"(have {sorted(cal.kernels)})")
    return [SimDevice(name, dc.throughput, launch_overhead=dc.overhead_s)
            for name, dc in sorted(cal.kernels[kernel].items())]


def sim_config(cal: Calibration, *, scheduler: str = "dynamic",
               scheduler_kwargs: Optional[Dict] = None,
               dispatch: str = "leased",
               lease_overhead_frac: Optional[float] = None,
               lease_k_max: Optional[int] = None,
               seed: int = 0) -> SimConfig:
    """A :class:`SimConfig` whose host terms come from the calibration:
    hand-offs cost the *measured* crossing, per-packet host management
    the *measured* wake."""
    return SimConfig(
        scheduler=scheduler,
        scheduler_kwargs=dict(scheduler_kwargs or {}),
        opt_init=True, opt_buffers=True, buffer_policy="pooled",
        dispatch=dispatch,
        sched_overhead_s=cal.sched_overhead_s,
        host_cost_per_packet=cal.wake_cost_s,
        lease_overhead_frac=lease_overhead_frac,
        lease_k_max=lease_k_max,
        seed=seed)


def bytes_per_wg(program: Program) -> float:
    """Per-work-group byte traffic of ``program``: its read-only inputs
    (``Program.in_bytes``) spread over its work-groups, plus one
    work-group's output rows — seeds ``SimDevice.xfer_bytes_per_wg`` for
    transfer-aware searches.  The JAX package reads the same figure from
    a compiled module's HLO, which also counts the traffic inside the
    kernel; this counts only what crosses to and from the device."""
    region = program.work_region
    if program.total_work <= 0:
        raise ValueError(f"total_work must be > 0, got "
                         f"{program.total_work}")
    cols = program.out_cols * (region.dims[1].size if region.ndim == 2
                               else 1)
    out = (program.out_rows_per_wg * cols
           * np.dtype(program.out_dtype).itemsize)
    return program.in_bytes / float(program.total_work) + out
