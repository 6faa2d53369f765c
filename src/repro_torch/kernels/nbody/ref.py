"""Plain PyTorch version of NBody (paper Table I: lws=64, 229376 bodies,
2:2 buffers, 7 kernel args): one Euler step of all-pairs gravitation.

``accelerations`` and ``step`` transcribe the JAX package's oracle op for
op; ``step_rows`` transcribes its range entry (``rsqrt(r2) / r2 * m``
interaction, packet rows [x, y, z, m, vx, vy, vz]) and is the plain
version of the fused CUDA kernel."""
from __future__ import annotations

import torch

EPS2 = 1e-3
DT = 0.005
# targets per block of step_rows: bounds the (T, N, 3) intermediates
_TGT_BLOCK = 512


def accelerations(pos_mass, tgt0: int, n_tgt: int):
    """pos_mass: (N, 4) = [x,y,z,m]; returns (n_tgt, 3) accelerations of
    bodies [tgt0, tgt0+n_tgt)."""
    tgt = pos_mass[tgt0:tgt0 + n_tgt, :3]
    src = pos_mass[:, :3]
    m = pos_mass[:, 3]
    d = src[None, :, :] - tgt[:, None, :]               # (T, N, 3)
    r2 = (d * d).sum(-1) + EPS2
    inv_r3 = torch.pow(r2, -1.5) * m[None, :]
    return (d * inv_r3[..., None]).sum(dim=1)           # (T, 3)


def step(pos_mass, vel, tgt0: int, n_tgt: int):
    """Euler update of the target slice; returns (new_pos_mass_slice,
    new_vel_slice) each (n_tgt, 4)/(n_tgt, 3)."""
    acc = accelerations(pos_mass, tgt0, n_tgt)
    v = vel[tgt0:tgt0 + n_tgt] + acc * DT
    p = pos_mass[tgt0:tgt0 + n_tgt, :3] + v * DT
    pm = torch.cat([p, pos_mass[tgt0:tgt0 + n_tgt, 3:]], dim=1)
    return pm, v


def step_rows(pos_mass, vel, tgt0: int, n_tgt: int):
    """(n_tgt, 7) rows [x, y, z, m, vx, vy, vz] of bodies [tgt0,
    tgt0+n_tgt) after one Euler step; targets go in blocks, each with the
    same per-target arithmetic."""
    src = pos_mass[:, :3]
    m = pos_mass[:, 3]
    rows = []
    for b0 in range(tgt0, tgt0 + n_tgt, _TGT_BLOCK):
        b1 = min(b0 + _TGT_BLOCK, tgt0 + n_tgt)
        tgt = pos_mass[b0:b1]
        d = src[None, :, :] - tgt[:, None, :3]
        r2 = (d * d).sum(-1) + EPS2
        inv_r3 = torch.rsqrt(r2) / r2 * m[None, :]
        acc = (d * inv_r3[..., None]).sum(dim=1)
        v = vel[b0:b1] + acc * DT
        p = tgt[:, :3] + v * DT
        rows.append(torch.cat([p, tgt[:, 3:], v], dim=1))
    if not rows:
        return pos_mass.new_empty((0, 7))
    return torch.cat(rows, dim=0)
