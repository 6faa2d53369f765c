"""Plain PyTorch version of Mandelbrot (paper Table I: lws=256, 14336px,
5000 max iterations, 4:1 out pattern, irregular workload).

Transcribes the JAX package's oracle op for op, with two exact choices
that keep the port's counts equal on every device: the pixel coordinates
are computed once with numpy float32 (IEEE division, no contraction, as
the CUDA kernel spells them), and the loop stops early once every pixel
of the tile has escaped, since an escaped pixel's z is frozen and its
count can no longer change."""
from __future__ import annotations

import numpy as np
import torch

# view window matching the classic AMD APP SDK sample
X0, X1 = -2.25, 0.75
Y0, Y1 = -1.5, 1.5
# iterations between the all-escaped checks (each one syncs a card)
_CHECK_EVERY = 64


def _axis(start: int, n: int, lo: float, hi: float, extent: int):
    """Pixel-centre coordinates lo + ((hi - lo) * (i + 0.5)) / extent of
    pixels [start, start+n), in float32."""
    i = np.arange(start, start + n).astype(np.float32)
    return np.float32(lo) + (np.float32(hi - lo) * (i + np.float32(0.5))
                             / np.float32(extent))


def escape_counts(row0: int, n_rows: int, width: int, height: int,
                  max_iter: int, col0: int = 0, n_cols: int = 0, *,
                  device="cpu"):
    """Iteration counts for the pixel tile rows [row0, row0+n_rows) x
    cols [col0, col0+n_cols); n_cols=0 means the full width."""
    if not n_cols:
        n_cols = width
    ys = torch.from_numpy(_axis(row0, n_rows, Y0, Y1, height)).to(device)
    xs = torch.from_numpy(_axis(col0, n_cols, X0, X1, width)).to(device)
    cr = xs[None, :].expand(n_rows, n_cols)
    ci = ys[:, None].expand(n_rows, n_cols)
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    cnt = torch.zeros(cr.shape, dtype=torch.int32, device=cr.device)
    for it in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        alive = (zr2 + zi2) <= 4.0
        new_zr = torch.where(alive, zr2 - zi2 + cr, zr)
        new_zi = torch.where(alive, 2 * zr * zi + ci, zi)
        zr, zi, cnt = new_zr, new_zi, cnt + alive.to(torch.int32)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(alive.any()):
            break
    return cnt
