"""The port's Mamba1 path on the CPU against the JAX package's: the plain
selective scan (what the wrapper ``kernels/mamba_scan/kernel.py`` and the
model's ``_ssm_scan_chunked`` take for a CPU tensor) against the JAX
oracle, its Pallas kernel in interpret mode and its chunked model scan;
the causal conv; one Mamba block; and the whole smoke ``falcon-mamba-7b``
(forward, prefill, teacher-forced decode) with the JAX weights of
``init_params(PRNGKey(0))`` carried over by ``params_from_jax``.  Inputs
are made with numpy from a seed and handed to both frameworks.

Tolerances: the scan at rtol 1e-4 / atol 1e-5 (``tests/test_kernels.py:
152``); the model at rtol/atol 2e-4 (``tests/test_torch_model.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels.mamba_scan import kernel as JKS, ops as JOS, ref as JRS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.kernels.mamba_scan import kernel as KS, ops as OS, ref as RS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

SCAN_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "falcon-mamba-7b"
B, S, P = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs, so it does not starve the others'
    timing-sensitive threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scan_inputs(B, S, di, ds, seed, with_h0=False):
    """a in [0.5, 0.99), b and h0 small, C standard normal: the inputs of
    ``tests/test_kernels.py::test_mamba_scan_kernel``."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0.5, 0.99, (B, S, di, ds)).astype(np.float32),
           (rng.standard_normal((B, S, di, ds)) * 0.1).astype(np.float32),
           rng.standard_normal((B, S, ds)).astype(np.float32)]
    if with_h0:
        out.append(rng.standard_normal((B, di, ds)).astype(np.float32))
    return out


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


# ------------------------------------------------------------ the scan
SCAN_SHAPES = [  # those of tests/test_kernels.py:139-143
    (1, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 64, 32),
    (2, 96, 48, 16, 32, 48),
]


@pytest.mark.parametrize("B,S,di,ds,chunk,tile_d", SCAN_SHAPES)
def test_plain_scan_matches_jax_oracle(B, S, di, ds, chunk, tile_d):
    a, b, C = _scan_inputs(B, S, di, ds, S + di)
    yr, hr = JRS.selective_scan_ref(*map(jnp.asarray, (a, b, C)))
    before = KS.launches
    y, h = KS.selective_scan(*_t(a, b, C))
    assert KS.launches == before          # the host takes the plain version
    assert y.shape == (B, S, di) and h.shape == (B, di, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **SCAN_TOL)


@pytest.mark.parametrize("B,S,di,ds,chunk,tile_d", SCAN_SHAPES)
def test_plain_scan_matches_pallas_interpret(B, S, di, ds, chunk, tile_d):
    a, b, C = _scan_inputs(B, S, di, ds, S * ds)
    yp, hp = JKS.selective_scan(*map(jnp.asarray, (a, b, C)), chunk=chunk,
                                tile_d=tile_d, interpret=True)
    y, h = RS.selective_scan(*_t(a, b, C))
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hp), **SCAN_TOL)


def test_scan_op_matches_jax_op():
    a, b, C = _scan_inputs(2, 128, 32, 8, 11)
    y1, h1 = JOS.selective_scan(*map(jnp.asarray, (a, b, C)), chunk=32)
    y2, h2 = OS.selective_scan(*_t(a, b, C), chunk=32)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y1), **SCAN_TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), **SCAN_TOL)
    assert OS.selective_scan_ref is RS.selective_scan


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16)])
def test_scan_with_state_matches_jax_chunked(S, chunk):
    """A nonzero h0 against the JAX model's chunked associative scan
    (S % chunk != 0 makes it one chunk)."""
    a, b, C, h0 = _scan_inputs(2, S, 24, 8, S, with_h0=True)
    yj, hj = JL._ssm_scan_chunked(*map(jnp.asarray, (a, b, C, h0)), chunk)
    y, h = L._ssm_scan_chunked(*_t(a, b, C, h0), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SCAN_TOL)
    yr, hr = JRS.selective_scan_ref(*map(jnp.asarray, (a, b, C, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **SCAN_TOL)


def test_plain_scan_carries_a_strongly_decaying_state():
    """a = exp(dt * A) with A down to -16 underflows a cumulative product;
    the sequential loop does not care."""
    rng = np.random.default_rng(4)
    dt = rng.uniform(0.5, 8.0, (1, 40, 6, 16)).astype(np.float32)
    A = -np.arange(1, 17, dtype=np.float32)
    a = np.exp(dt * A).astype(np.float32)
    b = rng.standard_normal(a.shape).astype(np.float32)
    C = rng.standard_normal((1, 40, 16)).astype(np.float32)
    y, h = RS.selective_scan(*_t(a, b, C))
    yr, hr = JRS.selective_scan_ref(*map(jnp.asarray, (a, b, C)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **SCAN_TOL)


def test_plain_scan_of_an_empty_sequence_returns_the_state():
    a, b, C, h0 = _scan_inputs(2, 0, 8, 4, 0, with_h0=True)
    y, h = KS.selective_scan(*_t(a, b, C, h0))
    assert y.shape == (2, 0, 8)
    np.testing.assert_array_equal(h.numpy(), h0)


# ------------------------------------------------------- the causal conv
@pytest.mark.parametrize("S,with_state", [(9, False), (2, False),
                                          (1, True), (5, True)])
def test_causal_conv_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    st = (rng.standard_normal((2, 3, 12)).astype(np.float32)
          if with_state else None)
    jy, jst = JL._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias),
                              None if st is None else jnp.asarray(st))
    y, new_st = L._causal_conv(*_t(x, w, bias),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(new_st.numpy(), np.asarray(jst))


# --------------------------------------------------------- a Mamba block
@pytest.fixture(scope="module")
def smoke():
    cfg, jcfg = get_smoke(ARCH), jax_get_smoke(ARCH)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, toks


def _layer0(jparams):
    return jax.tree.map(lambda t: t[0], jparams["blocks"]["sub0"]["mixer"])


def test_converted_block_keeps_the_jax_layouts(smoke):
    cfg, _, jparams, params, _ = smoke
    jp = _layer0(jparams)
    lp = params.layers[0]
    assert lp.ln2 is None and lp.mlp is None
    assert isinstance(lp.mixer, L.Mamba)
    for name in L.Mamba.NAMES:
        got = getattr(lp.mixer, name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jp[name]))
    assert lp.mixer.A_log.dtype == lp.mixer.D.dtype == torch.float32


def test_mamba_block_prefill_and_decode_match_jax(smoke):
    cfg, jcfg, jparams, params, _ = smoke
    jp, mixer = _layer0(jparams), params.layers[0].mixer
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, P + 2, cfg.d_model)).astype(np.float32)
    jc, _ = JL.mamba_cache_init(jcfg, B, jnp.float32)
    cache = L.mamba_cache_init(cfg, B, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jc.items()}
    jy, jc = JL.mamba_apply(jcfg, jp, jnp.asarray(x[:, :P]), cache=jc)
    y, cache = L.mamba_apply(cfg, mixer, torch.from_numpy(x[:, :P]),
                             cache=cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   **TOL)
    for i in range(P, P + 2):
        jy, jc = JL.mamba_apply(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                cache=jc, decode=True)
        y, cache = L.mamba_apply(cfg, mixer, torch.from_numpy(x[:, i:i + 1]),
                                 cache=cache, decode=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(cache["h"].numpy(), np.asarray(jc["h"]),
                                   **TOL)


def test_mamba_block_without_cache_matches_jax(smoke):
    cfg, jcfg, jparams, params, _ = smoke
    x = np.random.default_rng(3).standard_normal(
        (B, 20, cfg.d_model)).astype(np.float32)
    jy, jc = JL.mamba_apply(jcfg, _layer0(jparams), jnp.asarray(x))
    y, cache = L.mamba_apply(cfg, params.layers[0].mixer, torch.from_numpy(x))
    assert jc is None and cache is None
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


# ------------------------------------------------------ the whole model
def test_forward_logits_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    jcache, _ = JT.init_cache(jcfg, B, S)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :P]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for i in range(P, P + 4):
        jlg, jcache = JT.decode_step(jcfg, jparams,
                                     jnp.asarray(toks[:, i:i + 1]), jcache,
                                     jnp.int32(i))
        lg, cache = T.decode_step(cfg, params,
                                  torch.from_numpy(toks[:, i:i + 1]), cache,
                                  i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


def test_prefill_decode_match_own_forward(smoke):
    cfg, _, _, params, toks = smoke
    t = torch.from_numpy(toks)
    full, _ = T.forward(cfg, params, t)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, t[:, :P], cache)
    torch.testing.assert_close(lg[:, 0], full[:, P - 1], **TOL)
    for i in range(P, S):
        lg, cache = T.decode_step(cfg, params, t[:, i:i + 1], cache, i)
        torch.testing.assert_close(lg[:, 0], full[:, i], **TOL)


def test_mamba_cache_does_not_grow_with_max_seq():
    cfg = get_smoke(ARCH)
    short, long = (T.init_cache(cfg, 3, n, device="cpu") for n in (8, 4096))
    assert len(short) == cfg.n_layers
    for c0, c1 in zip(short, long):
        assert c0.keys() == c1.keys() == {"h", "conv"}
        assert c0["h"].shape == c1["h"].shape == (3, cfg.d_inner,
                                                  cfg.ssm.d_state)
        assert c0["h"].dtype == torch.float32
        assert c0["conv"].shape == (3, cfg.ssm.d_conv - 1, cfg.d_inner)


def test_own_init_is_seeded_and_shaped():
    cfg = get_smoke(ARCH)
    a = T.init_params(cfg, torch.Generator().manual_seed(0))
    b = T.init_params(cfg, torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad
    jshapes = jax.eval_shape(
        lambda: JT.init_params(jax_get_smoke(ARCH), jax.random.PRNGKey(0))[0])
    jmix = jshapes["blocks"]["sub0"]["mixer"]
    m = a.layers[0].mixer
    for name in L.Mamba.NAMES:
        assert tuple(getattr(m, name).shape) == jmix[name].shape[1:], name
        assert str(getattr(m, name).dtype).split(".")[-1] == str(
            jmix[name].dtype), name
    assert a.layers[0].ln2 is None and len(a.layers) == cfg.n_layers
