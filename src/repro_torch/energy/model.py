"""Per-device power models (the energy subsystem's value types).

The source paper's opening claim is that commodity heterogeneous systems
earn their place through performance *and energy*; the "Towards Green
Computing" OpenCL survey (PAPERS.md) shows the optimal device split can
*flip* when the objective is joules instead of seconds.  This module is
the J-side vocabulary: a :class:`PowerModel` describes how one device (or
the host path serving it) converts time and traffic into energy.

Four calibrated constants per device:

* ``busy_w``          — watts while the device is executing packets;
* ``idle_w``          — watts while powered but waiting (transfer stalls,
                        scheduler waits, the run tail after the device's
                        last packet);
* ``lock_j``          — joules per scheduler global-lock crossing charged
                        to the host path (thread wake + contended hand-off
                        — the energy twin of ``SimConfig.sched_overhead_s``);
* ``xfer_j_per_byte`` — joules per byte staged between host and device
                        (DMA + memcpy energy; zero-copy devices move no
                        bytes and pay nothing).

The default model is **all zeros**: every existing config, test, journal
replay and benchmark charges exactly 0 J and produces bit-identical
results — energy is an opt-in measurement surface, not a behavior change.

``EFFICIENCY`` (J per work-group at full speed, ``busy_w / throughput``)
is the quantity the energy-capped scheduler and the ``energy`` fleet
placement rank devices by; it lives with the consumers because it needs a
throughput, which is not the model's business.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class PowerModel:
    """How one device converts time and traffic into joules."""

    busy_w: float = 0.0           # W while executing packets
    idle_w: float = 0.0           # W while powered but waiting
    lock_j: float = 0.0           # J per scheduler lock crossing (host)
    xfer_j_per_byte: float = 0.0  # J per byte staged host<->device

    def __post_init__(self):
        for name in ("busy_w", "idle_w", "lock_j", "xfer_j_per_byte"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"PowerModel.{name} must be >= 0, got {v}")

    @property
    def is_zero(self) -> bool:
        """True for the default joule-blind model (all existing configs)."""
        return (self.busy_w == 0.0 and self.idle_w == 0.0
                and self.lock_j == 0.0 and self.xfer_j_per_byte == 0.0)

    def joules(self, busy_s: float, idle_s: float, *,
               crossings: int = 0, bytes_moved: float = 0.0) -> float:
        """The accounting identity, per device:

            J = busy_s * busy_w + idle_s * idle_w
                + crossings * lock_j + bytes_moved * xfer_j_per_byte

        Every executor (threaded engine, ``simulate``,
        ``simulate_serving``) charges energy through this one formula, so
        the per-run total is the sum of these terms by construction —
        the same way the five phase windows sum to the wall clock.
        """
        return (busy_s * self.busy_w + idle_s * self.idle_w
                + crossings * self.lock_j
                + bytes_moved * self.xfer_j_per_byte)


#: The joule-blind default shared by every device dataclass field.
ZERO_POWER = PowerModel()

#: Calibrated desktop-class presets (orders of magnitude from the green
#: computing OpenCL survey's CPU/iGPU/dGPU measurements, not this host):
#: the discrete GPU is fastest but hungriest, the iGPU is the efficiency
#: sweet spot, the CPU pays the worst J/wg.  Benchmarks and examples use
#: these; calibrated deployments fit their own.
PRESETS: Dict[str, PowerModel] = {
    "cpu": PowerModel(busy_w=65.0, idle_w=12.0, lock_j=2e-4,
                      xfer_j_per_byte=0.0),
    "igpu": PowerModel(busy_w=28.0, idle_w=5.0, lock_j=2e-4,
                       xfer_j_per_byte=0.0),
    "gpu": PowerModel(busy_w=180.0, idle_w=25.0, lock_j=2e-4,
                      xfer_j_per_byte=6e-9),
}
