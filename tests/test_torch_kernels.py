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
    # on the CPU the range entry runs the host routine: its packets tile
    # its whole-range call exactly, and that holds the plain version at
    # the kernel tests' rtol=1e-4, atol=1e-3 (expf against torch's exp)
    whole = KB.price_options(s0, k0, ty).numpy()
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole)
    np.testing.assert_allclose(whole, RB.price_options(s0, k0, ty).numpy(),
                               rtol=1e-4, atol=1e-3)


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


# ------------------------------------ the CUDA kernels' order of operations
# csrc/binomial.cu and csrc/nbody.cu round otherwise than their plain
# versions; these evaluate the kernels' arithmetic in float32 torch, so the
# change is held against the JAX package on the CPU too.
def _fma32(a, b, c):
    """fmaf in float32: a*b is exact in float64, then one rounding (two on
    a rare tie)."""
    return (a.double() * b.double() + c.double()).float()


# steps a pass over the lattice of csrc/binomial.cu (kFuse)
BINOMIAL_FUSE = 8


def _binomial_passes(steps, k):
    """The steps of each of the binomial kernel's passes: at each width of
    8..2 nodes a lane, passes of k until the front fits in one node fewer
    a lane, then at width 1 passes of k and single steps."""
    passes, f = [], steps + 1
    for w in range(8, 1, -1):
        keep = 32 * (w - 1)
        count = -(-(f - keep) // k) if f > keep else 0
        passes += [k] * count
        f -= count * k
    return passes + [k] * ((f - 1) // k) + [1] * ((f - 1) % k)


def _binomial_as_kernel(s0, strike, t_years, steps, fuse=BINOMIAL_FUSE):
    """The binomial kernel's order: the plain version's prologue and
    leaves, disc folded into the coefficients once, the coefficients of k
    steps by Pascal's rule, and a pass of k steps as one multiply and k
    FMAs a node: acc = c[k] * v[j+k], then acc = fmaf(c[i], v[j+i], acc)
    for i = k-1..0."""
    dt = t_years / steps
    vdt = RB.VOLATILITY * torch.sqrt(dt)
    u = torch.exp(vdt)
    d = 1.0 / u
    p = (torch.exp(RB.RISKFREE * dt) - d) / (u - d)
    disc = torch.exp(-RB.RISKFREE * dt)
    pu, pd = (disc * p)[:, None], (disc * (1.0 - p))[:, None]
    coef = {}
    for k in (1, fuse):
        c = [torch.ones_like(pu)] + [None] * k
        for kk in range(1, k + 1):
            c[kk] = pu * c[kk - 1]
            for i in range(kk - 1, 0, -1):
                c[i] = _fma32(pd, c[i], pu * c[i - 1])
            c[0] = pd * c[0]
        coef[k] = c
    j = torch.arange(steps + 1, dtype=torch.float32)
    s_t = s0[:, None] * torch.exp(vdt[:, None] * (2.0 * j[None, :] - steps))
    v = torch.clamp(s_t - strike[:, None], min=0.0)
    for k in _binomial_passes(steps, fuse):
        c, m = coef[k], v.shape[1] - k
        acc = c[k] * v[:, k:k + m]
        for i in range(k - 1, -1, -1):
            acc = _fma32(c[i], v[:, i:i + m], acc)
        v = acc
    return v[:, 0]


def _nbody_as_kernel(pm, tgt0, n_tgt, slices=8, tile=128):
    """The N-body kernel's order: eps2 folded into the first FMA of r2,
    s = (m * rsqrt(r2)) * rsqrt(r2)^2 without a division, each slice of the
    source tiles summed by one warp (a tile's terms into a partial by FMA,
    the partial into the slice's total), the slices added in warp order."""
    tgt = pm[tgt0:tgt0 + n_tgt, :3]
    n = pm.shape[0]
    n_tiles = -(-n // tile)
    per = -(-n_tiles // slices)
    acc = None
    for w in range(slices):
        total = torch.zeros(n_tgt, 3)
        for i in range(w * per, min((w + 1) * per, n_tiles)):
            src = pm[i * tile:(i + 1) * tile]
            d = src[None, :, :3] - tgt[:, None, :]
            dx, dy, dz = d.unbind(-1)
            r2 = _fma32(dx, dx, _fma32(dy, dy, _fma32(
                dz, dz, torch.full_like(dz, RN.EPS2))))
            inv = torch.rsqrt(r2)
            s = (src[None, :, 3] * inv) * (inv * inv)
            part = torch.zeros(n_tgt, 3)
            for k in range(src.shape[0]):
                part = _fma32(d[:, k], s[:, k, None], part)
            total = total + part
        acc = total if acc is None else acc + total
    return acc


@pytest.mark.parametrize("n,steps,tile", [(256, 64, 64), (512, 254, 128)])
def test_binomial_kernel_order_matches_jax(n, steps, tile):
    """rtol=1e-4, atol=1e-3 (tests/test_kernels.py:42), against the JAX
    oracle, the Pallas kernel in interpret mode and the plain version."""
    s0, k0, ty = OB.make_inputs(n, seed=11)
    jargs = [jnp.asarray(x) for x in (s0, k0, ty)]
    ref = np.asarray(JRB.price_options(*jargs, steps=steps))
    pallas = np.asarray(JKB.price_options(*jargs, steps=steps, tile=tile,
                                          interpret=True))
    args = (_t(s0), _t(k0), _t(ty))
    got = _binomial_as_kernel(*args, steps).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        got, RB.price_options(*args, steps=steps).numpy(), rtol=1e-4,
        atol=1e-3)


@pytest.mark.parametrize("n,tile_t,tile_s", [(256, 64, 128), (512, 128, 256)])
def test_nbody_kernel_order_matches_jax(n, tile_t, tile_s):
    """rtol=atol=2e-4 (tests/test_kernels.py:79), against the JAX oracle,
    the Pallas kernel in interpret mode and the plain version.  Tiles of 48
    sources (the kernel's are 128) leave a short last tile and slices with
    no tile at these N."""
    pm, _ = ON.make_inputs(n, seed=13)
    ref = np.asarray(JRN.accelerations(jnp.asarray(pm), 0, tile_t))
    pallas = np.asarray(JKN.accelerations(jnp.asarray(pm[:tile_t]),
                                          jnp.asarray(pm), tile_t=tile_t,
                                          tile_s=tile_s, interpret=True))
    got = _nbody_as_kernel(_t(pm), 0, tile_t, tile=48).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, RN.accelerations(_t(pm), 0,
                                                     tile_t).numpy(),
                               rtol=2e-4, atol=2e-4)


# the Mandelbrot kernel's iterations a block (csrc/mandelbrot.cu kUnroll)
MANDEL_UNROLL = 16


def _mandel_step(zr, zi, cr, ci):
    """One iteration as the kernel spells it: the escape test before it,
    and zi' = fmaf(zr * zi, 2, ci), which is (2 * (zr * zi)) + ci in
    float32 because 2 * p is exact."""
    zr2, zi2 = zr * zr, zi * zi
    inside = (zr2 + zi2) <= 4.0
    return inside, (zr2 - zi2) + cr, (2.0 * (zr * zi)) + ci


def _mandelbrot_as_kernel(row0, n_rows, width, height, max_iter, col0=0,
                          n_cols=0, unroll=MANDEL_UNROLL):
    """The Mandelbrot kernel's order: blocks of ``unroll`` steps with no
    test inside, whose escape tests fold into a sticky flag; a block whose
    flag fell is rolled back to the z saved at its start, and a checked
    one-step loop then runs to the escape (and the last max_iter % unroll
    steps of the rest)."""
    if not n_cols:
        n_cols = width
    xs = torch.from_numpy(RM._axis(col0, n_cols, RM.X0, RM.X1, width))
    ys = torch.from_numpy(RM._axis(row0, n_rows, RM.Y0, RM.Y1, height))
    cr = xs[None, :].expand(n_rows, n_cols)
    ci = ys[:, None].expand(n_rows, n_cols)
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    cnt = torch.zeros(cr.shape, dtype=torch.int32)
    blocked = torch.ones(cr.shape, dtype=torch.bool)
    for _ in range(max_iter // unroll):
        sr, si, ok = zr, zi, blocked.clone()
        for _ in range(unroll):
            inside, zr, zi = _mandel_step(zr, zi, cr, ci)
            ok &= inside
        zr, zi = torch.where(ok, zr, sr), torch.where(ok, zi, si)
        cnt += ok.to(torch.int32) * unroll
        blocked = ok
        if not bool(blocked.any()):
            break
    live = cnt < max_iter
    while bool(live.any()):
        inside, nzr, nzi = _mandel_step(zr, zi, cr, ci)
        live &= inside
        zr, zi = torch.where(live, nzr, zr), torch.where(live, nzi, zi)
        cnt += live.to(torch.int32)
        live &= cnt < max_iter
    return cnt


@pytest.mark.parametrize("row0,n_rows,w,h,iters,col0,n_cols,unroll", [
    (0, 64, 64, 64, 15, 0, 0, MANDEL_UNROLL),
    (0, 64, 64, 64, 16, 0, 0, MANDEL_UNROLL),
    (0, 64, 64, 64, 17, 0, 0, MANDEL_UNROLL),
    (0, 32, 128, 32, 200, 0, 0, MANDEL_UNROLL),
    (40, 32, 256, 128, 257, 0, 0, MANDEL_UNROLL),
    (8, 16, 96, 64, 300, 24, 45, MANDEL_UNROLL),
    (0, 64, 64, 64, 7, 0, 0, 8),         # blocks of 8: a timed variant
    (0, 64, 64, 64, 8, 0, 0, 8),
    (0, 64, 64, 64, 9, 0, 0, 8)])
def test_mandelbrot_kernel_order_matches_jax(row0, n_rows, w, h, iters,
                                             col0, n_cols, unroll):
    """Exactly the plain version's counts, and within the port's 0.5% of
    the pixels of the JAX oracle and the Pallas kernel in interpret mode,
    at iteration counts below, at and across a block."""
    got = _mandelbrot_as_kernel(row0, n_rows, w, h, iters, col0, n_cols,
                                unroll)
    assert torch.equal(got, RM.escape_counts(row0, n_rows, w, h, iters,
                                             col0, n_cols))
    ref = np.asarray(JRM.escape_counts(row0, n_rows, w, h, iters,
                                       col0=col0, n_cols=n_cols))
    assert (got.numpy() != ref).mean() <= 0.005
    if not n_cols:
        pallas = np.asarray(JKM.escape_counts(row0, n_rows, w, h, iters,
                                              tile_h=8, interpret=True))
        assert (got.numpy() != pallas).mean() <= 0.005


def _gaussian_as_kernel(ip, w1d, row0, n_rows, col0=0, n_cols=0):
    """The Gaussian kernel's order: each vertical sum and each output an
    FMA chain over k = 0..K-1 from 0, the horizontal pass on the vertical
    sums of the window's K - 1 + n_cols padded columns."""
    K = w1d.shape[0]
    if not n_cols:
        n_cols = ip.shape[1] - (K - 1) - col0
    band = ip[row0:row0 + n_rows + K - 1, col0:col0 + n_cols + K - 1]
    tmp = torch.zeros((n_rows, band.shape[1]))
    for k in range(K):
        tmp = _fma32(w1d[k].expand_as(tmp), band[k:k + n_rows], tmp)
    out = torch.zeros((n_rows, n_cols))
    for k in range(K):
        out = _fma32(w1d[k].expand_as(out), tmp[:, k:k + n_cols], out)
    return out


@pytest.mark.parametrize("h,w,ksize,tile", [(128, 64, 31, 64),
                                            (128, 200, 31, 32),
                                            (64, 96, 5, 16)])
def test_gaussian_kernel_order_matches_jax(h, w, ksize, tile):
    """rtol=atol=1e-5 (tests/test_kernels.py), against the plain version,
    the JAX oracle and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(h + w + ksize)
    img = rng.standard_normal((h, w)).astype(np.float32)
    ip, wts = OG.prepare(img, ksize)
    ref = np.asarray(JRG.blur_rows_ref(jnp.asarray(ip), jnp.asarray(wts),
                                       0, h))
    pallas = np.asarray(JKG.blur_rows(jnp.asarray(ip), jnp.asarray(wts),
                                      tile_h=tile, interpret=True))
    got = _gaussian_as_kernel(_t(ip), _t(wts), 0, h).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, RG.blur_rows_ref(_t(ip), _t(wts), 0, h).numpy(), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("ksize,row0,n_rows,col0,n_cols", [
    (31, 16, 48, 0, 40), (31, 0, 128, 77, 51), (5, 3, 61, 10, 1)])
def test_gaussian_column_window_matches_jax_run_region(ksize, row0, n_rows,
                                                       col0, n_cols):
    """The wrapper's column window on the CPU against the JAX package's
    tile entry ``run_region``, the full-width rows' columns and the
    kernel's order (rtol=atol=1e-5)."""
    img = np.random.default_rng(ksize + col0).standard_normal(
        (128, 128)).astype(np.float32)
    ip, wts = OG.prepare(img, ksize)
    ref = np.asarray(JOG.run_region(jnp.asarray(ip), jnp.asarray(wts), row0,
                                    n_rows, col0, n_cols))
    got = KG.blur_rows(_t(ip), _t(wts), row0, n_rows, col0, n_cols)
    assert got.shape == (n_rows, n_cols) and KG.launches == 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    full = KG.blur_rows(_t(ip), _t(wts), row0, n_rows)
    np.testing.assert_allclose(got.numpy(),
                               full[:, col0:col0 + n_cols].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), _gaussian_as_kernel(_t(ip), _t(wts), row0, n_rows, col0,
                                         n_cols).numpy(),
        rtol=1e-5, atol=1e-5)


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


# a wrapper's host routine against its plain version: exactly where the
# routine keeps the plain version's order of operations (the blur,
# Mandelbrot), else at the kernel tests' tolerances (binomial: expf
# against torch's exp; nbody: the sum over sources in another order)
WRAPPER_TOL = [(1e-4, 1e-3), None, None, (2e-4, 2e-4)]


@pytest.mark.parametrize("which", range(4))
def test_wrapper_on_cpu_takes_plain_version(which):
    """A CPU tensor takes the host routine (``host_calls``), never the
    card's kernel (``launches``), and gets the plain version's values."""
    mod, wrapped, plain = _wrapper_calls()[which]
    before = mod.host_calls
    got, want = wrapped().numpy(), plain().numpy()
    if WRAPPER_TOL[which] is None:
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = WRAPPER_TOL[which]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert mod.launches == 0 and mod.host_calls == before + 1


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
