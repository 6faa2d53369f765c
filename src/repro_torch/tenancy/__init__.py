"""Multi-tenant fleet arbitration: N concurrent sessions on one fleet.

The paper's co-execution runtime assumes one host program owns every
device; production traffic is many clients.  This package is the
coordination layer that removes that assumption: a :class:`FleetArbiter`
owns the WorkerPool + BufferArena and grants devices to tenant sessions
through fair-share credits (weighted virtual time), priority admission,
and an exclusive mode that fences the whole fleet.  Preemption happens
only at packet-lease boundaries, so every per-tenant run keeps the
exact-cover, phase, and energy identities of a solo session.
"""
from repro_torch.tenancy.arbiter import (
    FleetArbiter,
    PacketWindow,
    TenantConfig,
    TenantHandle,
    exclusive_overlaps,
    fair_share_index,
)

__all__ = [
    "FleetArbiter",
    "PacketWindow",
    "TenantConfig",
    "TenantHandle",
    "exclusive_overlaps",
    "fair_share_index",
]
