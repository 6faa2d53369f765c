"""Tier-1: ``coexec`` — one call, paper-tuned defaults.

Hides scheduler and optimization choices behind the configuration the
paper found best: HGuidedOpt balancing, parallel init with executable
caching, registered buffers.  For reuse across runs (where the paper's
optimizations actually pay off), hold an ``EngineSession`` instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.device import DeviceGroup
from repro_torch.core.metrics import RunResult
from repro_torch.core.region import Region
from repro_torch.core.runtime import Program
from repro_torch.api.policies import BufferPolicy, DevicePolicy
from repro_torch.api.session import EngineSession


def coexec(program: Program,
           devices: Optional[Sequence[DeviceGroup]] = None, *,
           scheduler: Optional[str] = None,
           scheduler_kwargs: Optional[Dict] = None,
           powers: Optional[List[float]] = None,
           buffer_policy: BufferPolicy = BufferPolicy.REGISTERED,
           device_policy: Optional[DevicePolicy] = None,
           parallel_init: bool = True,
           init_cost_s: float = 0.0,
           region: Optional[Region] = None,
           dispatch: str = "leased",
           tuned=None) -> RunResult:
    """Co-execute ``program`` across ``devices`` and return its RunResult.

    ``devices=None`` discovers the fleet via ``device_policy`` (default:
    one group per visible card plus a host ``cpu`` group; raises
    when no card is visible).  The result's ``output`` attribute
    holds the assembled host array: bit-identical to a single-device run
    on a fleet of one backend, within the kernels' tolerances on a mixed
    card + host fleet (Mandelbrot exactly).
    ``region`` restricts the one-shot run to a sub-NDRange of the program
    (lws-aligned per dimension); for *repeated* ROI offloads hold an
    ``EngineSession`` and use ``register_workload`` + ROI-mode submits.
    ``dispatch`` selects the scheduler hand-off: ``"leased"`` (default,
    lock-amortized packet plans) or ``"per_packet"`` (the classic
    one-lock-per-packet baseline).  ``tuned`` accepts a
    ``repro_torch.tune.TunedConfig`` (or ``True`` for a calibration-cache
    lookup): autotuned scheduler choice, lease constants, and transfer
    crossover become the run's defaults; explicit kwargs still win.
    """
    with EngineSession(devices,
                       scheduler=scheduler,
                       scheduler_kwargs=scheduler_kwargs,
                       buffer_policy=buffer_policy,
                       device_policy=device_policy,
                       parallel_init=parallel_init,
                       init_cost_s=init_cost_s,
                       dispatch=dispatch,
                       tuned=tuned,
                       name=f"coexec[{program.name}]") as session:
        return session.submit(program, powers=powers,
                              region=region).result()
