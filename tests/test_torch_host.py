"""The compiled C++ host routines (``repro_torch/csrc/host``) that the CPU
group runs, built here with ``g++``: each against its plain PyTorch
version and against the JAX package's jitted range entries, results
independent of the number of threads, the wrappers' counters and
argument checks, and the build route (no fallback, nothing at import).

Tolerances:

* against the plain version: Mandelbrot, the blur and the ray tracer
  exactly (each routine keeps the plain version's order of operations),
  binomial at rtol 1e-4 / atol 1e-3 (``expf`` against torch's vectorised
  ``exp``), nbody at rtol/atol 2e-4 (the sum over sources in another
  order), as ``tests/test_kernels.py`` holds the JAX kernels;
* against the JAX package, those of ``tests/test_torch_kernels.py`` and
  ``tests/test_torch_programs.py``: Mandelbrot on at most 0.5% of the
  pixels (XLA:CPU contracts ``a*b+c``), the blur at 1e-5, ray at rtol
  1e-5 / atol 1e-4 with no pixel flipped, at 64 px.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.binomial import ops as JOB
from repro.kernels.gaussian import ops as JOG
from repro.kernels.mandelbrot import ops as JOM
from repro.kernels.nbody import ops as JON
from repro.kernels.ray import ops as JOR
from repro_torch.kernels import host_build
from repro_torch.kernels.binomial import kernel as KB, ops as OB, ref as RB
from repro_torch.kernels.gaussian import kernel as KG, ops as OG, ref as RG
from repro_torch.kernels.mandelbrot import kernel as KM, ops as OM
from repro_torch.kernels.mandelbrot import ref as RM
from repro_torch.kernels.nbody import kernel as KN, ops as ON, ref as RN
from repro_torch.kernels.ray import ops as RO, ref as RR

SRC = Path(__file__).resolve().parents[1] / "src"
MANDEL_MAX_DIFF = 0.005
RAY_TOL = (1e-5, 1e-4)
RAY_FLIP = 1e-2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _counted(mod, fn):
    """fn() on the CPU: one host call, no card launch (ray has no card
    kernel to count)."""
    before = mod.host_calls
    out = fn()
    assert mod.host_calls == before + 1
    assert getattr(mod, "launches", 0) == 0
    return out


def _gaussian_inputs(h, w, ksize, seed):
    img = np.random.default_rng(seed).standard_normal((h, w)).astype(
        np.float32)
    return tuple(_t(x) for x in OG.prepare(img, ksize))


def _scene(which):
    return {k: _t(v) for k, v in RR.make_scene(which).items()}


# ------------------------------------------------ against the plain version
@pytest.mark.parametrize("row0,n_rows,w,h,iters,col0,n_cols", [
    (0, 64, 64, 64, 64, 0, 0),
    (8, 16, 96, 64, 300, 24, 45),        # col0 != 0, a ragged lane block
    (24, 16, 128, 64, 5000, 30, 45),     # across the set's edge
    (28, 8, 64, 64, 300, 36, 8),         # inside the cardioid: all max out
    (0, 8, 64, 64, 1, 0, 0),             # max_iter 1
    (0, 3, 200, 40, 17, 150, 50),        # the image's last columns
    (5, 1, 33, 9, 0, 0, 0)])             # max_iter 0
def test_mandelbrot_host_equals_plain(row0, n_rows, w, h, iters, col0,
                                      n_cols):
    got = _counted(KM, lambda: KM.escape_counts(
        row0, n_rows, w, h, iters, col0, n_cols, device="cpu"))
    want = RM.escape_counts(row0, n_rows, w, h, iters, col0, n_cols)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if (row0, col0, iters) == (28, 36, 300):
        assert bool((got == iters).all())


@pytest.mark.parametrize("ksize,h,w,row0,n_rows,col0,n_cols", [
    (31, 128, 200, 0, 128, 0, 0),        # whole image
    (31, 96, 130, 17, 1, 0, 0),          # one row
    (31, 128, 200, 100, 28, 150, 50),    # the last rows and columns
    (31, 128, 200, 0, 16, 0, 1),         # the first column alone
    (5, 64, 96, 3, 61, 10, 1),
    (1, 16, 16, 0, 16, 0, 0),            # one tap
    (63, 128, 100, 7, 100, 13, 80)])
def test_gaussian_host_equals_plain(ksize, h, w, row0, n_rows, col0,
                                    n_cols):
    ip, wt = _gaussian_inputs(h, w, ksize, ksize + h + col0)
    got = _counted(KG, lambda: KG.blur_rows(ip, wt, row0, n_rows, col0,
                                            n_cols))
    nc = n_cols or w - col0
    want = RG.blur_rows_ref(ip[:, col0:col0 + nc + ksize - 1], wt, row0,
                            n_rows)
    assert got.shape == (n_rows, nc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,steps", [(1, 254), (17, 254), (300, 254),
                                     (64, 1), (100, 31), (33, 255)])
def test_binomial_host_matches_plain(n, steps):
    s0, k0, ty = (_t(x) for x in OB.make_inputs(n, seed=n + steps))
    got = _counted(KB, lambda: KB.price_options(s0, k0, ty, steps=steps))
    want = RB.price_options(s0, k0, ty, steps=steps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("n,tgt0,n_tgt", [
    (512, 0, 512), (1000, 17, 300),      # N not a multiple of the lanes
    (300, 299, 1), (70, 5, 3),           # a short chunk of targets
    (7, 0, 7)])                          # fewer sources than lanes
def test_nbody_host_matches_plain(n, tgt0, n_tgt):
    pm, vel = (_t(x) for x in ON.make_inputs(n, seed=n))
    got = _counted(KN, lambda: KN.step_rows(pm, vel, tgt0, n_tgt))
    want = RN.step_rows(pm, vel, tgt0, n_tgt)
    assert got.shape == (n_tgt, 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("px,rows,cols", [
    (64, (0, 64), (0, 64)), (96, (20, 36), (8, 72)),
    (128, (4, 100), (40, 24)), (4096, (2000, 4), (0, 4096))])
def test_ray_host_equals_plain(which, px, rows, cols):
    """Bit for bit, 1-D (a packet of full rows through ``run_range``) and
    tiles (``run_region``), so no pixel flips either."""
    scene = _scene(which)
    want = RR.render_rows(scene, rows[0], rows[1], px, px, cols[0], cols[1])
    got = _counted(RO, lambda: RO.run_region(scene, rows[0], rows[1],
                                             cols[0], cols[1], width=px,
                                             height=px))
    assert torch.equal(got, want)
    if cols == (0, px) and rows[0] % RO.LWS == 0 and rows[1] % RO.LWS == 0:
        got = _counted(RO, lambda: RO.run_range(
            scene, rows[0] // RO.LWS, rows[1] // RO.LWS, width=px,
            height=px))
        assert torch.equal(got, want)


# ------------------------------------------ against the JAX package's jit
@pytest.mark.parametrize("entry", ["range", "region"])
def test_mandelbrot_host_close_to_jax_jit(entry):
    if entry == "range":
        want = np.asarray(JOM.run_range(2, 3, width=96, height=64,
                                        max_iter=300))
        got = OM.run_range(2, 3, width=96, height=64, max_iter=300,
                           device="cpu")
    else:
        want = np.asarray(JOM.run_region(8, 24, 16, 40, width=96, height=64,
                                         max_iter=300))
        got = OM.run_region(8, 24, 16, 40, width=96, height=64,
                            max_iter=300, device="cpu")
    assert got.shape == want.shape
    assert (got.numpy() != want).mean() <= MANDEL_MAX_DIFF


@pytest.mark.parametrize("entry", ["range", "region"])
def test_gaussian_host_matches_jax_jit(entry):
    img = np.random.default_rng(3).standard_normal((256, 96)).astype(
        np.float32)
    ip, wts = OG.prepare(img)
    jargs = (jnp.asarray(ip), jnp.asarray(wts))
    if entry == "range":
        want = np.asarray(JOG.run_range(*jargs, 1, 1))
        got = OG.run_range(_t(ip), _t(wts), 1, 1)
    else:
        want = np.asarray(JOG.run_region(*jargs, 200, 56, 40, 56))
        got = OG.run_region(_t(ip), _t(wts), 200, 56, 40, 56)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_binomial_host_matches_jax_jit():
    s0, k0, ty = OB.make_inputs(1024, seed=4)
    want = np.asarray(JOB.run_range(*(jnp.asarray(x) for x in (s0, k0, ty)),
                                    2, 5))
    got = OB.run_range(_t(s0), _t(k0), _t(ty), 2, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_nbody_host_matches_jax_jit():
    pm, vel = ON.make_inputs(640, seed=6)
    want = np.asarray(JON.run_range(jnp.asarray(pm), jnp.asarray(vel), 3, 4))
    got = ON.run_range(_t(pm), _t(vel), 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("entry", ["range", "region"])
def test_ray_host_matches_jax_jit(which, entry):
    jscene = {k: jnp.asarray(v) for k, v in RR.make_scene(which).items()}
    if entry == "range":
        want = np.asarray(JOR.run_range(jscene, 3, 5, width=64, height=64))
        got = RO.run_range(_scene(which), 3, 5, width=64, height=64)
    else:
        want = np.asarray(JOR.run_region(jscene, 8, 40, 12, 48, width=64,
                                         height=64))
        got = RO.run_region(_scene(which), 8, 40, 12, 48, width=64,
                            height=64)
    got = got.numpy()
    assert got.shape == want.shape
    per_px = np.abs(got - want).reshape(-1, 3).max(-1)
    assert int((per_px > RAY_FLIP).sum()) == 0
    np.testing.assert_allclose(got, want, rtol=RAY_TOL[0], atol=RAY_TOL[1])


# ------------------------------------------------- threads and counters
def _host_calls():
    ip, wt = _gaussian_inputs(200, 150, 31, 1)
    s0, k0, ty = (_t(x) for x in OB.make_inputs(200, seed=1))
    pm, vel = (_t(x) for x in ON.make_inputs(300, seed=1))
    scene = _scene(2)
    return {
        "mandelbrot": lambda: KM.escape_counts(0, 40, 300, 40, 500, 0, 0,
                                               device="cpu"),
        "gaussian": lambda: KG.blur_rows(ip, wt, 5, 150, 3, 140),
        "binomial": lambda: KB.price_options(s0, k0, ty),
        "nbody": lambda: KN.step_rows(pm, vel, 3, 290),
        "ray": lambda: RO.run_region(scene, 0, 48, 8, 40, width=64,
                                     height=64),
    }


@pytest.mark.parametrize("name", ["mandelbrot", "gaussian", "binomial",
                                  "nbody", "ray"])
def test_results_do_not_depend_on_the_thread_count(name):
    fn = _host_calls()[name]
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = fn()
        torch.set_num_threads(4)
        four = fn()
    finally:
        torch.set_num_threads(before)
    assert torch.equal(one, four)


def _bad_calls():
    ip, wt = _gaussian_inputs(64, 64, 31, 2)
    s0, k0, ty = (_t(x) for x in OB.make_inputs(128))
    pm, vel = (_t(x) for x in ON.make_inputs(128))
    scene = _scene(1)
    strided = torch.zeros(64, 188)[:, ::2]
    return [
        (KG, lambda: KG.blur_rows(ip.double(), wt, 0, 16)),
        (KG, lambda: KG.blur_rows(strided, wt, 0, 16)),
        (KG, lambda: KG.blur_rows(ip, wt[None], 0, 16)),
        (KG, lambda: KG.blur_rows(ip, wt, 60, 16)),           # past the end
        (KB, lambda: KB.price_options(s0.double(), k0, ty)),
        (KB, lambda: KB.price_options(s0, k0[:64], ty)),
        (KB, lambda: KB.price_options(torch.zeros(256)[::2], k0, ty)),
        (KN, lambda: KN.step_rows(pm[:, :3].contiguous(), vel, 0, 64)),
        (KN, lambda: KN.step_rows(pm.t().contiguous().t(), vel, 0, 64)),
        (KN, lambda: KN.step_rows(pm, vel.half(), 0, 64)),
        (KN, lambda: KN.step_rows(pm, vel, 100, 64)),         # past the end
        (RO, lambda: RO.run_region(dict(scene, radii=scene["radii"][:5]), 0,
                                   4, 0, 4, width=64, height=64)),
        (RO, lambda: RO.run_region(dict(scene, colors=scene["colors"]
                                        .double()), 0, 4, 0, 4, width=64,
                                   height=64)),
        (RO, lambda: RO.run_region(dict(scene, centers=scene["centers"]
                                        .t().contiguous().t()), 0, 4, 0, 4,
                                   width=64, height=64)),
        (RO, lambda: RO.run_region(scene, 62, 4, 0, 4, width=64,
                                   height=64)),               # past the end
    ]


@pytest.mark.parametrize("which", range(15))
def test_host_wrappers_refuse_what_the_routine_does_not_take(which):
    """Misshapen, non-float32 or strided inputs raise ``ValueError``
    before the routine runs: nothing is copied to make them fit."""
    mod, call = _bad_calls()[which]
    before = mod.host_calls
    with pytest.raises(ValueError):
        call()
    assert mod.host_calls == before


# ------------------------------------------------------- the build route
@pytest.mark.parametrize("name", ["mandelbrot", "gaussian", "binomial",
                                  "nbody", "ray"])
def test_missing_compiler_raises_and_never_falls_back(monkeypatch, tmp_path,
                                                      name):
    """No ``g++``: the first call raises ``RuntimeError`` naming it, and no
    plain version runs in its place."""
    calls = _host_calls()
    monkeypatch.setattr(host_build, "_lib", None)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build.shutil, "which", lambda *_: None)

    def plain(*_a, **_k):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(RM, "escape_counts", plain)
    monkeypatch.setattr(RG, "blur_rows_ref", plain)
    monkeypatch.setattr(RB, "price_options", plain)
    monkeypatch.setattr(RN, "step_rows", plain)
    monkeypatch.setattr(RR, "render_rows", plain)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        calls[name]()
    assert list(tmp_path.glob("*.so")) == []


def test_library_name_follows_sources_flags_and_cpu(monkeypatch):
    base = host_build._digest()
    assert base == host_build._digest()
    monkeypatch.setattr(host_build, "cpu_identity", lambda: "another cpu")
    assert host_build._digest() != base
    monkeypatch.undo()
    monkeypatch.setattr(host_build, "FLAGS", host_build.FLAGS + ["-g"])
    assert host_build._digest() != base
    for flag in ("-ffast-math", "-Ofast"):
        assert flag not in host_build.FLAGS
    assert "-ffp-contract=off" in host_build.FLAGS


def test_import_builds_nothing():
    """Importing the port runs no compiler: with no ``g++`` (nor anything
    else) on PATH every module imports, and no library is loaded."""
    code = ("import repro_torch, repro_torch.api, repro_torch.core.programs\n"
            "from repro_torch.kernels import build, host_build\n"
            "from repro_torch.kernels.ray import ops\n"
            "print(build._lib is None, host_build._lib is None)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), PATH="")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "True True"
