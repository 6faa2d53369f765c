"""Binomial op: range-partitionable entry.  One work-group = LWS options
(the paper's one-option-per-work-group with lws=255 turns into option
tiles)."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.binomial import kernel as K
from repro_torch.kernels.binomial import ref as R

LWS = 128
STEPS = R.STEPS


def make_inputs(n_options: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(5.0, 30.0, n_options).astype(np.float32)
    strike = rng.uniform(1.0, 100.0, n_options).astype(np.float32)
    ty = rng.uniform(0.25, 10.0, n_options).astype(np.float32)
    return s0, strike, ty


def run_range(s0, strike, ty, offset: int, size: int):
    """Price options of work-groups [offset, offset+size) on the device
    that holds the inputs."""
    a, b = offset * LWS, (offset + size) * LWS
    return K.price_options(s0[a:b], strike[a:b], ty[a:b], steps=STEPS)


def total_work(n_options: int) -> int:
    assert n_options % LWS == 0
    return n_options // LWS
