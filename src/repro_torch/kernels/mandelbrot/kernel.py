"""Wrapper of the hand-written CUDA Mandelbrot kernel
(``csrc/mandelbrot.cu``, one thread per pixel with early exit), which
replaces the JAX package's Pallas kernel ``kernels/mandelbrot/kernel.py``
``escape_counts``.  Its counts equal the plain version's exactly.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mandelbrot import ref as R

launches = 0


def escape_counts(row0: int, n_rows: int, width: int, height: int,
                  max_iter: int, col0: int = 0, n_cols: int = 0, *,
                  device="cuda"):
    """(n_rows, n_cols) int32 counts of the pixel tile rows [row0,
    row0+n_rows) x cols [col0, col0+n_cols) (n_cols=0: full width), on
    ``device``: the kernel on a card, the plain version on the CPU."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return R.escape_counts(row0, n_rows, width, height, max_iter,
                               col0, n_cols, device=device)
    if device.type != "cuda":
        raise ValueError(f"escape_counts: unsupported device {device}")
    if not n_cols:
        n_cols = width
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=device)
    build.launch("mandelbrot_counts", out, out.data_ptr(), row0, n_rows,
                 col0, n_cols, width, height, max_iter)
    launches += 1
    return out
