"""Device-group abstraction (the paper's Tier-3 ``Device``).

A DeviceGroup owns one executor (a ``torch.device``: ``cuda:i`` for a
card, ``cpu`` for the host) and runs range-partitioned packets of a
Program.  The per-packet throughput is EWMA-tracked — that is the online
computing-power estimate fed back to HGuidedOpt.

``device`` defaults to ``"cuda"``: the host CPU is used only when the
caller passes ``device="cpu"``.  ``throttle`` (>1 slows the device down by
sleeping the extra fraction of each packet's measured compute time)
provides *controlled* heterogeneity on a host whose executors are
identical (the CPU tests' throttled fleets).  ``fail_after`` injects a
hard device failure after N packets (fault-tolerance tests).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.energy.model import ZERO_POWER, PowerModel


class DeviceFailure(RuntimeError):
    pass


@dataclass
class DeviceGroup:
    name: str
    device: Any = "cuda"                  # torch.device or its name
    throttle: float = 1.0                 # >1 => proportionally slower
    fail_after: Optional[int] = None      # fail on the Nth packet
    ewma: float = 0.5
    # energy model (busy/idle W, lock J, transfer J/byte); the all-zero
    # default keeps every joule-blind config bit-identical (energy == 0)
    power_model: PowerModel = ZERO_POWER

    # runtime state
    packets_done: int = 0
    busy_time: float = 0.0
    finish_time: float = 0.0
    throughput: Optional[float] = None    # work-groups / s (EWMA)
    dead: bool = False

    def __post_init__(self):
        self.device = torch.device(self.device)

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def put(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def run_packet(self, fn: Callable, offset: int, size: int):
        """Execute fn(offset, size); returns (result, wg_per_s).  A CUDA
        group synchronises its device before the packet's time is read, so
        ``wg_per_s`` counts the kernels' run, not their enqueue."""
        if (self.fail_after is not None
                and self.packets_done >= self.fail_after):
            self.dead = True
            raise DeviceFailure(f"{self.name} failed (injected)")
        t0 = time.perf_counter()
        out = fn(offset, size)
        if self.is_cuda:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if self.throttle > 1.0:
            time.sleep(dt * (self.throttle - 1.0))
            dt *= self.throttle
        self.packets_done += 1
        self.busy_time += dt
        wg_per_s = size / max(dt, 1e-9)
        self.throughput = wg_per_s if self.throughput is None else (
            self.ewma * wg_per_s + (1 - self.ewma) * self.throughput)
        return out, wg_per_s


def reserve_feeder_cores(devices: Sequence[DeviceGroup]) -> None:
    """On a fleet that mixes cards and a host-CPU group, cap torch's
    intra-op threads so the CPU group's kernels leave one core per card
    for the thread that launches that card's packets."""
    n_cuda = sum(1 for d in devices if d.is_cuda)
    if n_cuda and any(not d.is_cuda for d in devices):
        torch.set_num_threads(max(1, (os.cpu_count() or 1) - n_cuda))
