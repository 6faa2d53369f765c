"""Energy subsystem: power models, joule accounting, energy-aware policy.

Layering: this package imports nothing from ``repro_torch.core`` (or above), so
core modules — device, metrics, scheduler, simulate, runtime — can attach
power models and stamp :class:`EnergyReport`s without an import cycle.

* :mod:`repro_torch.energy.model` — :class:`PowerModel` (busy/idle watts,
  lock-crossing J, transfer J/byte), the ``ZERO_POWER`` joule-blind
  default, and desktop-class ``PRESETS``.
* :mod:`repro_torch.energy.meter` — :class:`EnergyMeter` /
  :class:`EnergyReport`: one accounting-identity implementation shared by
  the threaded engine, ``simulate`` and ``simulate_serving``.

The energy-*policy* surfaces live with their peers: the budget-capped
``hguided_energy`` scheduler in ``repro_torch.core.scheduler`` and the
``energy`` fleet placement in ``repro_torch.fleet.placement``.
"""
from repro_torch.energy.meter import (  # noqa: F401
    DeviceEnergy, EnergyMeter, EnergyReport, meter_run, zero_report)
from repro_torch.energy.model import PRESETS, ZERO_POWER, PowerModel  # noqa

__all__ = [
    "PowerModel", "ZERO_POWER", "PRESETS",
    "DeviceEnergy", "EnergyMeter", "EnergyReport", "meter_run",
    "zero_report",
]
