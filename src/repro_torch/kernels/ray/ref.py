"""Raytracer benchmark (paper: open-source OpenCL raytracer [4], two
scenes, lws=128, custom structs, irregular workload).

Plain PyTorch version of a sphere-scene raytracer with one bounce of
Lambert shading + hard shadows, a transcription of the JAX package's op
for op.  It has no hand-written kernel, on either device: the JAX package
has no Pallas kernel for it either, since per-ray control flow is
data-dependent branching (shadow rays, misses) that ``torch.where``
already expresses as masked lanes.  Two scenes ("ray1", "ray2") differ in
sphere layout, giving different irregularity profiles (paper's Ray vs
Ray2).
"""
from __future__ import annotations

import numpy as np
import torch

_LIGHT = (8.0, 10.0, -2.0)
_BACKGROUND = (0.05, 0.05, 0.1)


def make_scene(which: int, n_spheres: int = 32, seed: int = 7):
    """The scene's float32 arrays on the host (``DeviceGroup.put`` stages
    them), from the JAX package's ``default_rng(seed + which)`` draws."""
    rng = np.random.default_rng(seed + which)
    if which == 1:
        centers = rng.uniform(-6, 6, (n_spheres, 3)).astype(np.float32)
        centers[:, 2] = rng.uniform(4, 14, n_spheres)
        radii = rng.uniform(0.4, 1.2, n_spheres).astype(np.float32)
    else:
        # scene 2: clustered spheres -> strongly irregular ray cost
        centers = (rng.standard_normal((n_spheres, 3)) * 1.5).astype(
            np.float32)
        centers[:, 2] = 8.0 + rng.standard_normal(n_spheres) * 0.8
        radii = rng.uniform(0.2, 2.2, n_spheres).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_spheres, 3)).astype(np.float32)
    return {"centers": centers, "radii": radii, "colors": colors}


def _dot(a, b):
    """Sum over the last axis (x, y, z) of ``a * b``, added in that order.
    Written out so that a card and the host round it alike: a reduction
    kernel may add three terms in another order on each device."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _axis(extent: int) -> np.ndarray:
    i = np.arange(extent).astype(np.float32) + np.float32(0.5)
    return i / np.float32(extent) * np.float32(2.0) - np.float32(1.0)


def pixel_axes(width: int, height: int):
    """Ray-direction coordinates (i + 0.5) / extent * 2 - 1 of every
    column (``xs``) and row (``ys``) of the image, float32 arrays on the
    host (``DeviceGroup.put`` stages them with the scene): a card divides
    by a scalar through its reciprocal, one rounding off true division.
    ``render_rows`` slices a tile out of them, so a band copies nothing."""
    return {"xs": _axis(width), "ys": _axis(height)}


def _sqrt(x):
    """Correctly rounded square root on either device.  On the host,
    ``torch.sqrt`` goes through a vector-math library that rounds within
    one ulp rather than to nearest (and whose first call in a process has
    been seen 3e-4 off), so a host tensor takes numpy's; a card's
    ``sqrt`` rounds to nearest."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _norm(x):
    return _sqrt(_dot(x, x))[..., None]


def _intersect(orig, dirn, centers, radii):
    """Returns (t_hit, idx) closest sphere per ray. orig/dirn: (..., 3).
    ``argmin`` takes the first of equal distances, so a ray that misses
    every sphere (all ``inf``) gets index 0, as ``jnp.argmin`` gives."""
    oc = orig[..., None, :] - centers                 # (..., S, 3)
    b = _dot(oc, dirn[..., None, :])
    c = _dot(oc, oc) - radii * radii
    disc = b * b - c
    ok = disc > 0
    sq = _sqrt(torch.where(ok, disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    t = torch.where(ok & (t > 1e-3), t, torch.inf)
    idx = torch.argmin(t, dim=-1)
    return torch.gather(t, -1, idx[..., None])[..., 0], idx


def render_rows(scene, row0: int, n_rows: int, width: int, height: int,
                col0: int = 0, n_cols: int = 0, axes=None):
    """Shade the pixel tile rows [row0, row0+n_rows) x cols
    [col0, col0+n_cols) -> (n_rows, n_cols, 3) on the scene's device;
    n_cols=0 = full width.  ``axes`` is ``pixel_axes(width, height)`` on
    that device (made here when absent)."""
    if not n_cols:
        n_cols = width
    centers, radii, colors = (scene[k] for k in ("centers", "radii",
                                                 "colors"))
    dev = centers.device
    if axes is None:
        axes = {k: torch.from_numpy(v).to(dev)
                for k, v in pixel_axes(width, height).items()}
    ys = axes["ys"][row0:row0 + n_rows]
    xs = axes["xs"][col0:col0 + n_cols]
    dirx = xs[None, :].expand(n_rows, n_cols)
    diry = (-ys[:, None]).expand(n_rows, n_cols)
    dirz = torch.ones((n_rows, n_cols), dtype=torch.float32, device=dev)
    d = torch.stack([dirx, diry, dirz], dim=-1)
    d = d / _norm(d)
    o = torch.zeros_like(d)
    t, idx = _intersect(o, d, centers, radii)
    hit = torch.isfinite(t)
    tsafe = torch.where(hit, t, 0.0)
    p = o + d * tsafe[..., None]
    n = p - centers[idx]
    n = n / torch.clamp(_norm(n), min=1e-6)
    light = torch.tensor(_LIGHT, dtype=torch.float32, device=dev)
    l = light - p  # noqa: E741
    l = l / torch.clamp(_norm(l), min=1e-6)  # noqa: E741
    lam = torch.clamp(_dot(n, l), min=0.0)
    # hard shadow ray
    ts, _ = _intersect(p + n * 1e-3, l, centers, radii)
    lit = ~torch.isfinite(ts)
    base = colors[idx]
    shade = base * (0.15 + 0.85 * lam * lit.to(torch.float32))[..., None]
    bg = torch.tensor(_BACKGROUND, dtype=torch.float32,
                      device=dev).expand(shade.shape)
    return torch.where(hit[..., None], shade, bg)
