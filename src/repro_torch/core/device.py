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

A CUDA group runs its packets on a stream of its own and waits only on
its own work, as the JAX package's ``block_until_ready`` of the packet's
output does: two groups that share a card (two serving replicas, two
training groups) then time their own kernels, not each other's.
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
    # CUDA groups: seconds between each packet's start and end events on
    # the group's stream, summed (the host clock's ``busy_time`` also
    # counts the launches' host work and the throttle's sleep)
    kernel_time: float = 0.0

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._stream = None

    @property
    def stream(self):
        """The group's own CUDA stream, made at first use (constructing a
        group touches no card)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def put(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def run_packet(self, fn: Callable, offset: int, size: int):
        """Execute fn(offset, size); returns (result, wg_per_s).  A CUDA
        group runs ``fn`` on its own stream, after the caller's stream
        (where its inputs were ``put``), and waits on an event recorded
        after the packet's work before the packet's time is read, so
        ``wg_per_s`` counts its kernels' run, not their enqueue, and not
        another group's kernels on the same card.  The output's tensors
        are recorded on the caller's stream, which may read them next."""
        if (self.fail_after is not None
                and self.packets_done >= self.fail_after):
            self.dead = True
            raise DeviceFailure(f"{self.name} failed (injected)")
        t0 = time.perf_counter()
        if self.is_cuda:
            out = self._run_on_stream(fn, offset, size)
        else:
            out = fn(offset, size)
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

    def _run_on_stream(self, fn: Callable, offset: int, size: int):
        stream = self.stream
        caller = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            start.record(stream)
            out = fn(offset, size)
            end.record(stream)
        _record_tensors(out, caller)
        end.synchronize()
        self.kernel_time += start.elapsed_time(end) / 1e3
        return out


def _record_tensors(out, stream) -> None:
    """Mark every CUDA tensor of ``out`` (nested in tuples, lists and
    dicts) as used on ``stream``: the caching allocator then keeps its
    memory until the work queued there at its release is done."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda and out.device == stream.device:
            out.record_stream(stream)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _record_tensors(x, stream)
    elif isinstance(out, dict):
        for x in out.values():
            _record_tensors(x, stream)


def reserve_feeder_cores(devices: Sequence[DeviceGroup]) -> None:
    """On a fleet that mixes cards and a host-CPU group, cap torch's
    intra-op threads (which the host routines of ``csrc/host`` also take
    as their thread count) so the CPU group leaves one core per card for
    the thread that launches that card's packets."""
    n_cuda = sum(1 for d in devices if d.is_cuda)
    if n_cuda and any(not d.is_cuda for d in devices):
        torch.set_num_threads(max(1, (os.cpu_count() or 1) - n_cuda))
