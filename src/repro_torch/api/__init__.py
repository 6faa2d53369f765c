"""The tiered co-execution API (EngineCL's usability thesis, in
PyTorch).

Three tiers, increasing control:

  * **Tier-1** ``coexec(program, devices=...)`` — single call, paper-tuned
    defaults (HGuidedOpt, parallel init, registered buffers); accepts a
    ``region=`` sub-NDRange.
  * **Tier-2** ``EngineSession`` — executable cache, buffer registry and
    elastic device membership shared across many programs;
    ``session.submit(program) -> RunHandle`` (``.result()``, ``.done()``,
    ``.cancel()``) overlaps input prep with in-flight runs;
    ``submit(..., deps=[h1, h2])`` builds a dependency DAG dispatched
    ready-set style (each node starts the moment its actual predecessors
    finish; cancelled predecessors cascade, failed ones raise
    ``DependencyError``), and ``submit(..., journal=RunJournal(path))``
    journals packet commits so ``resume_run`` restarts a killed graph
    executing only never-committed packets;
    ``register_workload`` + ``submit(..., region=..., mode=OffloadMode.
    ROI)`` is the paper's ROI offloading, ``mode=OffloadMode.BINARY`` its
    self-contained binary offloading.
  * **Tier-3** extension points — ``register_scheduler`` (plugin registry),
    ``DevicePolicy`` (discovery/ordering), ``BufferPolicy`` (Runtime
    buffer handling).

Work geometry is first-class: ``Region``/``Dim`` describe 1-D and 2-D
NDRanges with per-dimension offset/size/lws; every scheduler carves them
(2-D as row panels) and every ``RunResult`` carries a per-phase
``PhaseBreakdown`` (init / h2d / roi / d2h / teardown).  The memory
subsystem (``repro_torch.core.membuf``) backs ``BufferPolicy.POOLED`` — the
default for warm ROI submits: run buffers lease from the session's
``BufferArena`` and staging overlaps compute on the ``TransferPipeline``
(pooled outputs are recycled views; copy what you keep).
"""
from repro_torch.api.handles import (CancelledError, DependencyError,
                                     RunHandle)
from repro_torch.api.policies import (BufferPolicy, DevicePolicy,
                                      OffloadMode, StaticDevicePolicy)
from repro_torch.api.session import EngineSession
from repro_torch.api.tier1 import coexec
from repro_torch.ckpt.checkpoint import ResumeReport, RunJournal, resume_run
from repro_torch.core.membuf import (ArenaPartition, ArenaStats,
                                     BufferArena, TransferPipeline)
from repro_torch.core.metrics import PhaseBreakdown
from repro_torch.core.region import Dim, Region
from repro_torch.core.runtime import Program
from repro_torch.core.scheduler import (GraphProgress,
                                        available_schedulers,
                                        register_scheduler,
                                        scheduler_accepts,
                                        unregister_scheduler)
from repro_torch.tenancy import (FleetArbiter, PacketWindow, TenantConfig,
                                 exclusive_overlaps, fair_share_index)

__all__ = [
    "ArenaPartition", "ArenaStats", "BufferArena", "BufferPolicy",
    "CancelledError", "DependencyError", "DevicePolicy", "Dim",
    "EngineSession", "FleetArbiter", "GraphProgress", "OffloadMode",
    "PacketWindow", "PhaseBreakdown", "Program", "Region", "ResumeReport",
    "RunHandle", "RunJournal", "StaticDevicePolicy", "TenantConfig",
    "TransferPipeline", "available_schedulers", "coexec",
    "exclusive_overlaps", "fair_share_index", "register_scheduler",
    "resume_run", "scheduler_accepts", "unregister_scheduler",
]
