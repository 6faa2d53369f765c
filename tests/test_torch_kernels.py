"""Per-kernel parity of the PyTorch port on the CPU: each plain PyTorch
version (``repro_torch.kernels.*.ref``, what a wrapper runs on a CPU
tensor) against the JAX package's ``ref.py`` and its Pallas kernel run in
interpret mode, at the shapes of ``tests/test_kernels.py``.  Inputs are
made once with numpy from a seed and handed to both frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.binomial import kernel as JKB, ops as JOB, ref as JRB
from repro.kernels.gaussian import kernel as JKG, ops as JOG, ref as JRG
from repro.kernels.mandelbrot import kernel as JKM, ref as JRM
from repro.kernels.nbody import kernel as JKN, ops as JON, ref as JRN
from repro_torch.kernels.binomial import kernel as KB, ops as OB, ref as RB
from repro_torch.kernels.gaussian import kernel as KG, ops as OG, ref as RG
from repro_torch.kernels.mandelbrot import kernel as KM, ops as OM, ref as RM
from repro_torch.kernels.nbody import kernel as KN, ops as ON, ref as RN


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- gaussian
@pytest.mark.parametrize("h,w,ksize,tile", [(128, 64, 7, 16),
                                            (128, 256, 31, 64),
                                            (256, 128, 15, 32)])
def test_gaussian_plain_matches_jax(h, w, ksize, tile):
    rng = np.random.default_rng(h * w + ksize)
    img = rng.standard_normal((h, w)).astype(np.float32)
    pad = ksize // 2
    ip = np.pad(img, pad, mode="edge")
    wts = JRG.gaussian_weights(ksize)
    ref = np.asarray(JRG.blur_rows_ref(jnp.asarray(ip), jnp.asarray(wts),
                                       0, h))
    pallas = np.asarray(JKG.blur_rows(jnp.asarray(ip), jnp.asarray(wts),
                                      tile_h=tile, interpret=True))
    got = RG.blur_rows_ref(_t(ip), _t(wts), 0, h).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_gaussian_range_consistency():
    rng = np.random.default_rng(42)
    img = rng.standard_normal((256, 128)).astype(np.float32)
    ip, w = OG.prepare(img)
    ipt, wt = _t(ip), _t(w)
    parts = [OG.run_range(ipt, wt, i, 1) for i in range(OG.total_work(img))]
    full = RG.blur_full_ref(_t(img))
    np.testing.assert_allclose(torch.cat(parts).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    jfull = np.asarray(JRG.blur_full_ref(jnp.asarray(img)))
    np.testing.assert_allclose(full.numpy(), jfull, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- binomial
@pytest.mark.parametrize("n,steps,tile", [(256, 64, 64), (512, 254, 128)])
def test_binomial_plain_matches_jax(n, steps, tile):
    """rtol=1e-4, atol=1e-3 (tests/test_kernels.py:42): the two frameworks'
    exp/sqrt and XLA's FMA contraction differ in the last bits, which 254
    induction steps grow to ~3e-4 absolute on 4,096 options."""
    s0, k0, ty = OB.make_inputs(n)
    jargs = [jnp.asarray(x) for x in (s0, k0, ty)]
    ref = np.asarray(JRB.price_options(*jargs, steps=steps))
    pallas = np.asarray(JKB.price_options(*jargs, steps=steps, tile=tile,
                                          interpret=True))
    got = RB.price_options(_t(s0), _t(k0), _t(ty), steps=steps).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-3)


def test_binomial_range_and_monotone_in_spot():
    s0 = torch.linspace(5.0, 50.0, 20)
    v = RB.price_options(s0, torch.full((20,), 25.0), torch.full((20,), 2.0))
    assert bool((torch.diff(v) >= -1e-5).all())
    s0, k0, ty = (_t(x) for x in OB.make_inputs(1024, seed=3))
    parts = [OB.run_range(s0, k0, ty, i, 2) for i in range(0, 8, 2)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  RB.price_options(s0, k0, ty).numpy())


# -------------------------------------------------------------- mandelbrot
def test_mandelbrot_exact_at_small_shape():
    """64x64 px, 64 iterations: the escape counts equal the JAX oracle's and
    the Pallas kernel's exactly."""
    ref = np.asarray(JRM.escape_counts(0, 64, 64, 64, 64))
    pallas = np.asarray(JKM.escape_counts(0, 64, 64, 64, 64, tile_h=8,
                                          interpret=True))
    got = RM.escape_counts(0, 64, 64, 64, 64).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("row0,n_rows,w,h,iters,col0,n_cols", [
    (0, 32, 128, 32, 200, 0, 0),
    (8, 16, 96, 64, 300, 24, 40),
    (40, 32, 256, 128, 500, 0, 0)])
def test_mandelbrot_counts_close_to_jax(row0, n_rows, w, h, iters, col0,
                                        n_cols):
    """At most 0.5% of the pixels may differ from the JAX oracle: XLA:CPU
    contracts a*b+c into one fused multiply-add, PyTorch and the port's
    CUDA kernel round each operation, and a boundary pixel's orbit then
    escapes one iteration apart (measured: 4 of 4,096 pixels at 128x32 px
    and 200 iterations).  Inside the port the counts are exact."""
    ref = np.asarray(JRM.escape_counts(row0, n_rows, w, h, iters,
                                       col0=col0, n_cols=n_cols))
    got = RM.escape_counts(row0, n_rows, w, h, iters, col0, n_cols).numpy()
    assert got.shape == ref.shape
    assert (got != ref).mean() <= 0.005
    if not n_cols and n_rows % 8 == 0:
        pallas = np.asarray(JKM.escape_counts(row0, n_rows, w, h, iters,
                                              tile_h=8, interpret=True))
        assert (got != pallas).mean() <= 0.005


def test_mandelbrot_interior_maxes_out_and_ranges_tile():
    cnt = RM.escape_counts(30, 4, 64, 64, 50)       # middle rows
    assert int(cnt.max()) == 50
    parts = [OM.run_range(i, 1, width=64, height=64, max_iter=80,
                          device="cpu") for i in range(OM.total_work(64))]
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  RM.escape_counts(0, 64, 64, 64, 80).numpy())


# ------------------------------------------------------------------ nbody
@pytest.mark.parametrize("n,tile_t,tile_s", [(256, 64, 128), (512, 128, 256)])
def test_nbody_plain_matches_jax(n, tile_t, tile_s):
    pm, vel = ON.make_inputs(n)
    ref = np.asarray(JRN.accelerations(jnp.asarray(pm), 0, tile_t))
    pallas = np.asarray(JKN.accelerations(jnp.asarray(pm[:tile_t]),
                                          jnp.asarray(pm), tile_t=tile_t,
                                          tile_s=tile_s, interpret=True))
    got = RN.accelerations(_t(pm), 0, tile_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_nbody_step_rows_match_jax_range(use_pallas):
    """The fused kernel's plain version against the JAX range entry (its
    jnp path and its Pallas path, which applies the Euler step after the
    kernel)."""
    pm, vel = ON.make_inputs(512, seed=5)
    ref = np.asarray(JON.run_range(jnp.asarray(pm), jnp.asarray(vel), 2, 4,
                                   use_pallas=use_pallas))
    got = ON.run_range(_t(pm), _t(vel), 2, 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    pm_s, v_s = RN.step(_t(pm), _t(vel), 128, 256)
    np.testing.assert_allclose(
        np.concatenate([pm_s.numpy(), v_s.numpy()], 1), got,
        rtol=2e-4, atol=2e-4)


def test_nbody_momentum_conservation():
    """Equal masses: total acceleration ~ 0 (Newton's third law)."""
    pm, _ = ON.make_inputs(128)
    pm[:, 3] = 1.0
    acc = RN.accelerations(_t(pm), 0, 128)
    assert float(acc.sum(0).abs().max()) < 1e-2


# ---------------------------------------------------- inputs carried across
@pytest.mark.parametrize("seed", [0, 7])
def test_inputs_byte_identical(seed):
    """The port's input makers give the JAX package's bytes for a seed —
    what makes the two compute the same thing."""
    for t, j in zip(OB.make_inputs(4096, seed), JOB.make_inputs(4096, seed)):
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
    for t, j in zip(ON.make_inputs(640, seed), JON.make_inputs(640, seed)):
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
    img = np.random.default_rng(seed).standard_normal((64, 48)).astype(
        np.float32)
    for t, j in zip(OG.prepare(img), JOG.prepare(img)):
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
    assert (OB.LWS, OG.LWS, OM.LWS, ON.LWS) == (128, 128, 8, 64)
    assert RN.EPS2 == JRN.EPS2 and RN.DT == JRN.DT
    assert (RB.STEPS, RB.RISKFREE, RB.VOLATILITY) == \
        (JRB.STEPS, JRB.RISKFREE, JRB.VOLATILITY)
    assert (RM.X0, RM.X1, RM.Y0, RM.Y1) == (JRM.X0, JRM.X1, JRM.Y0, JRM.Y1)


# ---------------------------------------------------------------- wrappers
def _wrapper_calls():
    s0, k0, ty = (_t(x) for x in OB.make_inputs(256))
    ip, w = (_t(x) for x in OG.prepare(
        np.random.default_rng(1).standard_normal((64, 32)).astype(
            np.float32)))
    pm, vel = (_t(x) for x in ON.make_inputs(128))
    return [
        (KB, lambda: KB.price_options(s0, k0, ty),
         lambda: RB.price_options(s0, k0, ty)),
        (KG, lambda: KG.blur_rows(ip, w, 8, 16),
         lambda: RG.blur_rows_ref(ip, w, 8, 16)),
        (KM, lambda: KM.escape_counts(8, 8, 32, 32, 40, device="cpu"),
         lambda: RM.escape_counts(8, 8, 32, 32, 40)),
        (KN, lambda: KN.step_rows(pm, vel, 64, 64),
         lambda: RN.step_rows(pm, vel, 64, 64)),
    ]


@pytest.mark.parametrize("which", range(4))
def test_wrapper_on_cpu_takes_plain_version(which):
    mod, wrapped, plain = _wrapper_calls()[which]
    before = mod.launches
    np.testing.assert_array_equal(wrapped().numpy(), plain().numpy())
    assert mod.launches == before == 0


@pytest.mark.parametrize("which", range(4))
def test_wrapper_refuses_a_tensor_off_cpu_and_cuda(which):
    """A tensor on neither the CPU nor a card (here ``meta``) is refused
    before anything is built or launched: nothing falls back."""
    meta = torch.empty(256, device="meta")
    calls = [
        lambda: KB.price_options(meta, meta, meta),
        lambda: KG.blur_rows(torch.empty(64, 62, device="meta"),
                             torch.empty(31, device="meta"), 0, 16),
        lambda: KM.escape_counts(0, 8, 32, 32, 40, device="meta"),
        lambda: KN.step_rows(torch.empty(128, 4, device="meta"),
                             torch.empty(128, 3, device="meta"), 0, 64),
    ]
    mod = [KB, KG, KM, KN][which]
    with pytest.raises(ValueError):
        calls[which]()
    assert mod.launches == 0
