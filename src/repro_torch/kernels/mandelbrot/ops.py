"""Mandelbrot op: range-partitionable entries (one work-group = LWS image
rows; the 2-D entry takes a pixel tile)."""
from __future__ import annotations

from repro_torch.kernels.mandelbrot import kernel as K

LWS = 8            # rows per work-group (alignment unit for packets)
MAX_ITER = 5000


def run_range(offset: int, size: int, *, width: int, height: int,
              max_iter: int = MAX_ITER, device="cuda"):
    """Escape counts of the rows of work-groups [offset, offset+size)."""
    return K.escape_counts(offset * LWS, size * LWS, width, height,
                           max_iter, device=device)


def run_region(row0: int, n_rows: int, col0: int, n_cols: int, *,
               width: int, height: int, max_iter: int = MAX_ITER,
               device="cuda"):
    """Escape counts for the pixel tile [row0, row0+n_rows) x
    [col0, col0+n_cols) (the NDRange entry, coordinates in pixels)."""
    return K.escape_counts(row0, n_rows, width, height, max_iter, col0,
                           n_cols, device=device)


def total_work(height: int) -> int:
    assert height % LWS == 0
    return height // LWS
