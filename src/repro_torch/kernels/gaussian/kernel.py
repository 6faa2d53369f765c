"""Wrapper of the hand-written CUDA Gaussian blur kernel
(``csrc/gaussian.cu``: taps and the vertical window in registers, one
CTA of 5 warps per 40 x 128 output tile), which replaces the JAX
package's Pallas kernel ``kernels/gaussian/kernel.py`` ``blur_rows``.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gaussian import ref as R

launches = 0


def blur_rows(img_padded, w1d, row0: int, n_rows: int, col0: int = 0,
              n_cols: int = 0):
    """Blur the output tile rows [row0, row0+n_rows) x columns [col0,
    col0+n_cols) (n_cols=0: the full width W) of the edge-padded image
    ``img_padded`` (H + K - 1, W + K - 1) with taps ``w1d`` (K,); returns
    (n_rows, n_cols).  CPU tensors take the plain version on the window's
    padded columns; CUDA tensors launch the kernel, which reads the tile
    straight from the whole image."""
    global launches
    K = w1d.shape[0]
    Hp, Wp = img_padded.shape
    if not n_cols:
        n_cols = Wp - (K - 1) - col0
    if not (0 <= col0 and 0 < n_cols and col0 + n_cols + K - 1 <= Wp):
        raise ValueError(f"blur_rows: columns [{col0}, {col0 + n_cols}) "
                         f"with K={K} do not fit the padded width {Wp}")
    if img_padded.device.type == "cpu":
        return R.blur_rows_ref(img_padded[:, col0:col0 + n_cols + K - 1],
                               w1d, row0, n_rows)
    build.check_cuda("blur_rows img_padded", img_padded, torch.float32, 2)
    build.check_cuda("blur_rows w1d", w1d, torch.float32, 1)
    if w1d.device != img_padded.device:
        raise ValueError("blur_rows: w1d and img_padded on different cards")
    if not (1 <= K <= 63 and 0 <= row0 and row0 + n_rows + K - 1 <= Hp):
        raise ValueError(f"blur_rows: rows [{row0}, {row0 + n_rows}) with "
                         f"K={K} do not fit the padded height {Hp}")
    out = torch.empty((n_rows, n_cols), dtype=torch.float32,
                      device=img_padded.device)
    build.launch("gaussian_blur_rows", img_padded, img_padded.data_ptr(),
                 w1d.data_ptr(), out.data_ptr(), row0, n_rows, col0, n_cols,
                 Hp, Wp, K)
    launches += 1
    return out
