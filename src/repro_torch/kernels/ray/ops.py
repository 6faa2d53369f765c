"""Ray op: range-partitionable entries (one work-group = LWS pixel rows;
paper scene sizes 4096px).

``_intersect`` builds (rows, cols, spheres, 3) float32 temporaries, 3.2 GB
each for a 2,048-row packet of a 4,096-px image.  So both entries render
a packet in bands of rows whose temporaries hold at most ``BAND_ELEMS``
elements; every pixel is independent, so banding changes no value."""
from __future__ import annotations

import torch

from repro_torch.kernels.ray import ref as R

LWS = 4            # rows per work-group
BAND_ELEMS = 1 << 25   # elements of one (rows, cols, spheres, 3) temporary


def _band_rows(n_cols: int, n_spheres: int) -> int:
    return max(1, BAND_ELEMS // (n_cols * n_spheres * 3))


def _render(scene, row0: int, n_rows: int, col0: int, n_cols: int, *,
            width: int, height: int, axes):
    dev = scene["centers"].device
    if axes is None:
        axes = {k: torch.from_numpy(v).to(dev)
                for k, v in R.pixel_axes(width, height).items()}
    band = _band_rows(n_cols, scene["centers"].shape[0])
    if band >= n_rows:
        return R.render_rows(scene, row0, n_rows, width, height, col0,
                             n_cols, axes)
    out = torch.empty((n_rows, n_cols, 3), dtype=torch.float32, device=dev)
    for r in range(0, n_rows, band):
        nr = min(band, n_rows - r)
        out[r:r + nr] = R.render_rows(scene, row0 + r, nr, width, height,
                                      col0, n_cols, axes)
    return out


def run_range(scene, offset: int, size: int, *, width: int, height: int,
              axes=None, **_):
    """Render work-groups [offset, offset+size) -> (size*LWS, width, 3)
    on the device that holds the scene.  ``axes`` is
    ``ref.pixel_axes(width, height)`` staged on that device, made once per
    program build (made per call when absent)."""
    return _render(scene, offset * LWS, size * LWS, 0, width, width=width,
                   height=height, axes=axes)


def run_region(scene, row0: int, n_rows: int, col0: int, n_cols: int, *,
               width: int, height: int, axes=None):
    """Render the pixel tile [row0, row0+n_rows) x [col0, col0+n_cols)
    -> (n_rows, n_cols, 3) (the NDRange entry, coordinates in pixels)."""
    return _render(scene, row0, n_rows, col0, n_cols, width=width,
                   height=height, axes=axes)


def total_work(height: int) -> int:
    assert height % LWS == 0
    return height // LWS
