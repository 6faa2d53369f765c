"""Tier-3 extension points and submit policies: offload mode, buffer and
device policies.

Schedulers have their own Tier-3 hook — ``repro_torch.core.scheduler.
register_scheduler`` — so all three of the paper's architectural roles
(Runtime buffers, device discovery, load balancing) are extensible without
touching the session.
"""
from __future__ import annotations

import enum
from typing import List, Sequence

import torch

from repro_torch.core.device import DeviceGroup, reserve_feeder_cores
from repro_torch.core.membuf import BufferPolicy

__all__ = ["BufferPolicy", "DevicePolicy", "OffloadMode",
           "StaticDevicePolicy"]


class OffloadMode(enum.Enum):
    """How a submit pays the paper's management overheads.

    * ``BINARY`` — the paper's binary offloading: the submit is fully
      self-contained, init -> offload -> teardown.  Executables are built
      fresh (never taken from the session cache) and any cached state under
      the program's name is evicted afterwards; the phase breakdown charges
      the full init and teardown to THIS run.  This is the per-run cost a
      one-shot offload actually pays.
    * ``ROI`` — the paper's region-of-interest offloading: the program
      must first be registered as a persistent workload
      (``EngineSession.register_workload``), which pays init once; each
      ROI submit then executes a sub-region (``region=``) against the
      registered executables and buffers, so back-to-back submits pay only
      the ROI window.  This is where the paper's optimizations yield
      17.4% instead of 7.5%.

    ``None`` (the default at ``submit``) keeps the session's legacy
    semantics: executables cached per session policy, no forced teardown.
    """
    BINARY = "binary"
    ROI = "roi"


# BufferPolicy lives in repro_torch.core.membuf (the memory subsystem owns the
# Runtime's buffer-handling contracts: PER_PACKET / REGISTERED / POOLED);
# it is re-exported here because it is a Tier-3 policy surface.


class DevicePolicy:
    """Device discovery + ordering hook.

    The default discovers one DeviceGroup per visible card (``cuda:i``)
    plus one host ``cpu`` group — the paper's CPU+GPU pair — and keeps
    that order.  Subclass to pin custom fleets (throttled groups, CPU-only
    test fleets) or to reorder (e.g. weakest-first so Static delivery
    matches the paper's CPU,iGPU,GPU layout).
    """

    def discover(self) -> List[DeviceGroup]:
        """One group per ``cuda:i`` followed by one ``cpu`` group.

        Runs on the cards by default and raises ``RuntimeError`` when
        CUDA is unavailable: it never falls back to a CPU-only fleet.  A
        CPU-only fleet is built by passing ``DeviceGroup(...,
        device="cpu")`` groups explicitly."""
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DevicePolicy.discover: no CUDA device is visible; pass "
                "devices=[DeviceGroup(name, device='cpu'), ...] to run on "
                "the host CPU")
        groups = [DeviceGroup(f"cuda{i}", device=f"cuda:{i}")
                  for i in range(torch.cuda.device_count())]
        return groups + [DeviceGroup("cpu", device="cpu")]

    def order(self, devices: Sequence[DeviceGroup]) -> List[DeviceGroup]:
        return list(devices)

    def resolve(self, devices=None) -> List[DeviceGroup]:
        """Explicit devices win; otherwise discover.  Always ordered."""
        devs = list(devices) if devices is not None else self.discover()
        devs = self.order(devs)
        if not devs:
            raise ValueError("DevicePolicy produced no devices")
        names = [d.name for d in devs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names: {names}")
        reserve_feeder_cores(devs)
        return devs


class StaticDevicePolicy(DevicePolicy):
    """A fixed, pre-built fleet (the common case in tests/benchmarks)."""

    def __init__(self, devices: Sequence[DeviceGroup]):
        self._devices = list(devices)

    def discover(self) -> List[DeviceGroup]:
        return list(self._devices)
