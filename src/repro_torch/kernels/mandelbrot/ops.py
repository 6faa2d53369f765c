"""Mandelbrot op: range-partitionable entry (one work-group = LWS image
rows)."""
from __future__ import annotations

from repro_torch.kernels.mandelbrot import kernel as K

LWS = 8            # rows per work-group (alignment unit for packets)
MAX_ITER = 5000


def run_range(offset: int, size: int, *, width: int, height: int,
              max_iter: int = MAX_ITER, device="cuda"):
    """Escape counts of the rows of work-groups [offset, offset+size)."""
    return K.escape_counts(offset * LWS, size * LWS, width, height,
                           max_iter, device=device)


def total_work(height: int) -> int:
    assert height % LWS == 0
    return height // LWS
