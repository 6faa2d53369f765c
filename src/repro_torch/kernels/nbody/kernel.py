"""Wrapper of the hand-written CUDA NBody kernel (``csrc/nbody.cu``, one
thread per target, source tiles through shared memory, Euler step fused),
which replaces the JAX package's Pallas kernel ``kernels/nbody/kernel.py``
``accelerations`` together with the Euler update of its ``ops.py``.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.nbody import ref as R

launches = 0


def step_rows(pos_mass, vel, tgt0: int, n_tgt: int):
    """(n_tgt, 7) rows [x, y, z, m, vx, vy, vz] of bodies [tgt0,
    tgt0+n_tgt) after one Euler step against all (N, 4) ``pos_mass``
    sources.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    global launches
    if pos_mass.device.type == "cpu":
        return R.step_rows(pos_mass, vel, tgt0, n_tgt)
    build.check_cuda("step_rows pos_mass", pos_mass, torch.float32, 2)
    build.check_cuda("step_rows vel", vel, torch.float32, 2)
    n = pos_mass.shape[0]
    if pos_mass.shape[1] != 4 or tuple(vel.shape) != (n, 3):
        raise ValueError(f"step_rows: expected (N, 4) and (N, 3), got "
                         f"{tuple(pos_mass.shape)} and {tuple(vel.shape)}")
    if vel.device != pos_mass.device:
        raise ValueError("step_rows: pos_mass and vel on different cards")
    if pos_mass.data_ptr() % 16:
        raise ValueError("step_rows: pos_mass must be 16-byte aligned")
    if not (0 <= tgt0 and tgt0 + n_tgt <= n):
        raise ValueError(f"step_rows: targets [{tgt0}, {tgt0 + n_tgt}) "
                         f"outside {n} bodies")
    out = torch.empty((n_tgt, 7), dtype=torch.float32,
                      device=pos_mass.device)
    build.launch("nbody_step", pos_mass, pos_mass.data_ptr(),
                 vel.data_ptr(), out.data_ptr(), n, tgt0, n_tgt, R.EPS2,
                 R.DT)
    launches += 1
    return out
