"""Selective-scan op: the model stack's scan
(``models/layers.py::_ssm_scan_chunked``), which launches the CUDA kernel
on a card and takes the plain version on the host."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import ref as R
from repro_torch.models.layers import _ssm_scan_chunked


def selective_scan(a, b, C, *, chunk: int = 128):
    """a, b: (B,S,di,ds); C: (B,S,ds) -> (y (B,S,di), h_T (B,di,ds)), from
    a zero state.  ``chunk`` is the JAX schedule's block length; the
    kernel carries the state over the whole sequence and ignores it."""
    B, S, di, ds = a.shape
    h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=a.device)
    return _ssm_scan_chunked(a, b, C, h0, chunk)


selective_scan_ref = R.selective_scan
