"""NBody op: range-partitionable entry (lws=64 bodies)."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.nbody import kernel as K
from repro_torch.kernels.nbody import ref as R

LWS = 64
DT = R.DT


def make_inputs(n_bodies: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n_bodies, 3)).astype(np.float32) * 10.0
    mass = rng.uniform(0.5, 2.0, (n_bodies, 1)).astype(np.float32)
    vel = rng.standard_normal((n_bodies, 3)).astype(np.float32) * 0.1
    return np.concatenate([pos, mass], 1), vel


def run_range(pos_mass, vel, offset: int, size: int):
    """Returns (size*LWS, 7) rows: [x,y,z,m,vx,vy,vz] after one step."""
    return K.step_rows(pos_mass, vel, offset * LWS, size * LWS)


def total_work(n_bodies: int) -> int:
    assert n_bodies % LWS == 0
    return n_bodies // LWS
