"""Mesh definitions, the JAX package's ``launch/mesh.py``.

A mesh here is axis names and sizes (``parallel.sharding.Mesh``): the
planner resolves specs and per-device shapes on it without touching a
device.  ``make_production_mesh`` gives the JAX package's named shapes,
16x16 ("data", "model") and 2x16x16 ("pod", "data", "model"), against
which the port's plans are held; ``make_test_mesh`` covers the cards the
port runs on.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.parallel.sharding import Mesh

# the planner's meshes by name (``launch.dryrun --mesh``), as ("data",
# "model") shapes: one card, four cards of one host tensor-parallel, and
# four split two by two (the JAX package's test mesh over four devices)
CARD_MESHES = {"h100": (1, 1), "h100x4": (1, 4), "h100x2x2": (2, 2)}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod ("data","model") or 2x16x16 multi-pod
    ("pod","data","model") mesh: the JAX package's production shapes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(n_devices: Optional[int] = None, model: int = 4) -> Mesh:
    """("data", "model") mesh over ``n_devices`` cards (default: those
    present, at least 1): ``model`` of them tensor-parallel when they
    divide by it, else all data-parallel.  One card is (1, 1), four are
    (1, 4), or (2, 2) with ``model=2``."""
    if n_devices is None:
        import torch
        n_devices = max(torch.cuda.device_count(), 1)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    model = model if n_devices % model == 0 else 1
    return Mesh(("data", "model"), (n_devices // model, model))


def card_mesh(name: str) -> Mesh:
    """The mesh a ``--mesh`` name stands for (``CARD_MESHES``)."""
    if name not in CARD_MESHES:
        raise KeyError(f"unknown mesh {name!r}; known: {sorted(CARD_MESHES)}")
    return Mesh(("data", "model"), CARD_MESHES[name])


def coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each axis of ``mesh``: ranks numbered
    row-major, the last axis fastest, as the JAX package's
    ``np.array(jax.devices()).reshape(mesh.shape)`` places its devices."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    out = {}
    for name, n in reversed(list(zip(mesh.axis_names, mesh.shape))):
        rank, out[name] = divmod(rank, n)
    return {name: out[name] for name in mesh.axis_names}
