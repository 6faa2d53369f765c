"""Gaussian blur op: range-partitionable co-execution entries.

``run_range(img_padded, w, offset, size)`` computes work-groups
[offset, offset+size) where one work-group = ``LWS`` output rows — the unit
the schedulers partition (paper Table I: lws=128).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.gaussian import kernel as K
from repro_torch.kernels.gaussian import ref as R

LWS = 128          # output rows per work-group (paper: local work size)
KSIZE = 31


def prepare(img: np.ndarray, ksize: int = KSIZE):
    """Host-side setup: pad once (read-only input buffer)."""
    pad = ksize // 2
    ip = np.pad(img, pad, mode="edge").astype(np.float32)
    w = R.gaussian_weights(ksize)
    return ip, w


def run_range(img_padded, w, offset: int, size: int):
    """Blur output work-groups [offset, offset+size); returns
    (size*LWS, W) rows on the device that holds the image."""
    return K.blur_rows(img_padded, w, offset * LWS, size * LWS)


def run_region(img_padded, w, row0: int, n_rows: int, col0: int,
               n_cols: int):
    """Blur the output tile [row0, row0+n_rows) x [col0, col0+n_cols)
    (the NDRange entry: coordinates in output pixels of the image padded
    once), on the device that holds the image: the kernel reads the tile
    straight from the whole padded image, so re-offloading an ROI pays
    only the kernel, as the paper's ROI mode requires."""
    return K.blur_rows(img_padded, w, row0, n_rows, col0, n_cols)


def total_work(img: np.ndarray) -> int:
    assert img.shape[0] % LWS == 0
    return img.shape[0] // LWS
