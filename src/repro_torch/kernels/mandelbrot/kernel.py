"""Wrapper of the hand-written CUDA Mandelbrot kernel
(``csrc/mandelbrot.cu``: one thread per pixel with early exit, the
iterations in unchecked blocks rolled back at an escape), which replaces
the JAX package's Pallas kernel ``kernels/mandelbrot/kernel.py``
``escape_counts``.  Its counts equal the plain version's exactly.  On the
host the compiled routine ``csrc/host/mandelbrot.cpp`` computes them, as
exactly.

``launches`` counts the kernel's launches and nothing else;
``host_calls`` counts the host routine's calls."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, host_build
from repro_torch.kernels.mandelbrot import ref as R

launches = 0
host_calls = 0


def escape_counts(row0: int, n_rows: int, width: int, height: int,
                  max_iter: int, col0: int = 0, n_cols: int = 0, *,
                  device="cuda"):
    """(n_rows, n_cols) int32 counts of the pixel tile rows [row0,
    row0+n_rows) x cols [col0, col0+n_cols) (n_cols=0: full width), on
    ``device``: the kernel on a card, the host routine on the CPU."""
    global launches, host_calls
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"escape_counts: unsupported device {device}")
    if not n_cols:
        n_cols = width
    if device.type == "cpu":
        xs = torch.from_numpy(R._axis(col0, n_cols, R.X0, R.X1, width))
        ys = torch.from_numpy(R._axis(row0, n_rows, R.Y0, R.Y1, height))
        out = torch.empty((n_rows, n_cols), dtype=torch.int32)
        host_build.call("host_mandelbrot_counts", out.data_ptr(),
                        xs.data_ptr(), ys.data_ptr(), n_rows, n_cols,
                        max_iter)
        host_calls += 1
        return out
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=device)
    build.launch("mandelbrot_counts", out, out.data_ptr(), row0, n_rows,
                 col0, n_cols, width, height, max_iter)
    launches += 1
    return out
