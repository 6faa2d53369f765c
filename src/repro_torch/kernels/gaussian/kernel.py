"""Wrapper of the hand-written CUDA Gaussian blur kernel
(``csrc/gaussian.cu``: taps and the vertical window in registers, one
CTA of 5 warps per 40 x 128 output tile), which replaces the JAX
package's Pallas kernel ``kernels/gaussian/kernel.py`` ``blur_rows``.  On
the host the compiled routine ``csrc/host/gaussian.cpp`` blurs in the
plain version's order.

``launches`` counts the kernel's launches and nothing else;
``host_calls`` counts the host routine's calls."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, host_build

launches = 0
host_calls = 0


def blur_rows(img_padded, w1d, row0: int, n_rows: int, col0: int = 0,
              n_cols: int = 0):
    """Blur the output tile rows [row0, row0+n_rows) x columns [col0,
    col0+n_cols) (n_cols=0: the full width W) of the edge-padded image
    ``img_padded`` (H + K - 1, W + K - 1) with taps ``w1d`` (K,); returns
    (n_rows, n_cols).  CPU tensors run the host routine, CUDA tensors
    launch the kernel; both read the tile straight from the whole image."""
    global launches, host_calls
    K = w1d.shape[0]
    Hp, Wp = img_padded.shape
    if not n_cols:
        n_cols = Wp - (K - 1) - col0
    if not (0 <= col0 and 0 < n_cols and col0 + n_cols + K - 1 <= Wp):
        raise ValueError(f"blur_rows: columns [{col0}, {col0 + n_cols}) "
                         f"with K={K} do not fit the padded width {Wp}")
    if img_padded.device.type == "cpu":
        host_build.check_host("blur_rows img_padded", img_padded, 2)
        host_build.check_host("blur_rows w1d", w1d, 1)
        if not (1 <= K and 0 <= row0 and row0 + n_rows + K - 1 <= Hp):
            raise ValueError(f"blur_rows: rows [{row0}, {row0 + n_rows}) "
                             f"with K={K} do not fit the padded height {Hp}")
        out = torch.empty((n_rows, n_cols), dtype=torch.float32)
        host_build.call("host_gaussian_blur_rows", img_padded.data_ptr(),
                        w1d.data_ptr(), out.data_ptr(), row0, n_rows, col0,
                        n_cols, Hp, Wp, K)
        host_calls += 1
        return out
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
