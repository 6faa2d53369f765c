"""EnergyMeter: integrate per-device time windows into joules.

The meter is the energy twin of :class:`repro_torch.core.runtime.PhaseClock`:
one accounting implementation shared by every executor.  Each device
contributes a :class:`DeviceEnergy` sample — busy seconds, a powered
window, lock crossings and bytes moved — and the report's totals are the
sums of the per-device terms **by construction** (the accounting
identity, enforced the same way the five phase windows sum to the wall
clock):

    total_j == sum_d ( busy_d * busy_w_d + idle_d * idle_w_d
                       + crossings_d * lock_j_d
                       + bytes_d * xfer_j_per_byte_d )

Executors fill the samples from bookkeeping they already keep:

* the threaded engine: ``RunResult.device_busy`` against the ROI window,
  the scheduler's per-device lock-crossing counters, and the bytes its
  device loops actually staged/committed;
* ``simulate`` / ``simulate_serving``: the modeled busy/stall split
  :meth:`SimDevice.packet_cost` now exposes, the same per-device crossing
  counters (same scheduler objects), and the modeled byte traffic.

Both charge the *same* :class:`repro_torch.energy.model.PowerModel`, which is
what makes the sim/hardware energy cross-check meaningful.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.energy.model import PowerModel, ZERO_POWER


@dataclass(frozen=True)
class DeviceEnergy:
    """One device's energy sample over one run (or serving window).

    ``idle_s`` is derived: the powered window minus the busy time,
    clamped at zero (measured busy can exceed the window by clock
    granularity).  A dead device's window ends at its death — it is
    powered off, not idling, for the rest of the run.
    """
    name: str
    model: PowerModel
    busy_s: float
    window_s: float
    crossings: int = 0
    bytes_moved: float = 0.0

    @property
    def idle_s(self) -> float:
        return max(0.0, self.window_s - self.busy_s)

    @property
    def busy_j(self) -> float:
        return self.busy_s * self.model.busy_w

    @property
    def idle_j(self) -> float:
        return self.idle_s * self.model.idle_w

    @property
    def lock_j(self) -> float:
        return self.crossings * self.model.lock_j

    @property
    def xfer_j(self) -> float:
        return self.bytes_moved * self.model.xfer_j_per_byte

    @property
    def total_j(self) -> float:
        return self.model.joules(self.busy_s, self.idle_s,
                                 crossings=self.crossings,
                                 bytes_moved=self.bytes_moved)


@dataclass(frozen=True)
class EnergyReport:
    """Per-run joule accounting: per-device samples plus their totals."""
    devices: Tuple[DeviceEnergy, ...]

    @property
    def total_j(self) -> float:
        return sum(d.total_j for d in self.devices)

    @property
    def busy_j(self) -> float:
        return sum(d.busy_j for d in self.devices)

    @property
    def idle_j(self) -> float:
        return sum(d.idle_j for d in self.devices)

    @property
    def lock_j(self) -> float:
        return sum(d.lock_j for d in self.devices)

    @property
    def xfer_j(self) -> float:
        return sum(d.xfer_j for d in self.devices)

    def identity_gap(self) -> float:
        """|total - (busy + idle + lock + xfer)| — 0 up to float
        associativity; the property suite asserts it stays below 1e-9
        relative across every scheduler under fault injection."""
        return abs(self.total_j
                   - (self.busy_j + self.idle_j + self.lock_j
                      + self.xfer_j))

    def by_name(self, name: str) -> DeviceEnergy:
        for d in self.devices:
            if d.name == name:
                return d
        raise KeyError(name)

    def row(self) -> str:
        return (f"total={self.total_j:.3f}J busy={self.busy_j:.3f}J "
                f"idle={self.idle_j:.3f}J lock={self.lock_j:.4f}J "
                f"xfer={self.xfer_j:.4f}J")


class EnergyMeter:
    """Accumulate per-device samples; emit one :class:`EnergyReport`.

    ``add`` may be called once per device (batch runs) or repeatedly
    (serving: cumulative busy/crossings/bytes per round are re-sampled —
    the *last* sample per name wins, so callers pass running totals).
    """

    def __init__(self):
        self._samples: List[DeviceEnergy] = []

    def add(self, name: str, model: Optional[PowerModel], *,
            busy_s: float, window_s: float, crossings: int = 0,
            bytes_moved: float = 0.0) -> DeviceEnergy:
        sample = DeviceEnergy(name=name, model=model or ZERO_POWER,
                              busy_s=busy_s, window_s=window_s,
                              crossings=crossings, bytes_moved=bytes_moved)
        self._samples = [s for s in self._samples if s.name != name]
        self._samples.append(sample)
        return sample

    def report(self) -> EnergyReport:
        return EnergyReport(devices=tuple(self._samples))


def meter_run(result, models: Sequence[Optional[PowerModel]],
              names: Sequence[str], *,
              crossings: Optional[Sequence[int]] = None,
              bytes_moved: Optional[Sequence[float]] = None,
              windows: Optional[Sequence[float]] = None) -> EnergyReport:
    """Meter a finished run from its existing phase accounting.

    ``result`` is duck-typed ``RunResult``: ``device_busy`` gives the
    per-device busy seconds and ``phases.roi_s`` the shared powered
    window (a device is powered for the whole co-execution window, busy
    for its measured slice of it).  ``windows`` overrides the per-device
    window — the simulator passes a dead device's death time.
    """
    n = len(names)
    roi = result.phases.roi_s if result.phases is not None else 0.0
    meter = EnergyMeter()
    for i in range(n):
        meter.add(
            names[i], models[i] if i < len(models) else None,
            busy_s=result.device_busy[i],
            window_s=windows[i] if windows is not None else roi,
            crossings=crossings[i] if crossings is not None else 0,
            bytes_moved=bytes_moved[i] if bytes_moved is not None else 0.0)
    return meter.report()


def zero_report(names: Iterable[str]) -> EnergyReport:
    """The joule-blind report: every device 0 J (back-compat surface)."""
    return EnergyReport(devices=tuple(
        DeviceEnergy(name=n, model=ZERO_POWER, busy_s=0.0, window_s=0.0)
        for n in names))
