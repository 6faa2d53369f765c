"""The gradient of causal GQA attention in the port, on the CPU: the
plain version of the backward kernel (``attention_bwd_ref``, the
explicit formulas with P materialised) against ``jax.vjp`` of the JAX
package's oracle ``kernels/flash_attention/ref.py`` ``attention_ref`` and
against torch autograd of the port's ``attention_ref``; the log-sum-exp
that the forward keeps for the backward (``attention_lse_ref``) against
``jax.nn.logsumexp`` of the oracle's scores, and the plain backward fed
with it against the one that forms its own softmax.  All in float32 at
rtol 1e-5 / atol 1e-6.  The CUDA kernels themselves are held against the
plain versions in ``tests/test_torch_cuda.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as JRA
from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(1, 16, 4, 2, 8), (2, 37, 4, 2, 16), (1, 70, 4, 1, 32),
          (2, 9, 4, 4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch's intra-op pool small while this module runs (the suite
    runs files in parallel workers with timing-sensitive JAX tests)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(B, S, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D),
                      (B, S, H, D))]


@pytest.mark.parametrize("B,S,H,KH,D", SHAPES)
def test_attention_bwd_ref_matches_jax_vjp(B, S, H, KH, D):
    q, k, v, dout = _inputs(B, S, H, KH, D, S + H)
    out, vjp = jax.vjp(JRA.attention_ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = RA.attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(np.array(out)),
                               torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("B,S,H,KH,D", SHAPES)
def test_attention_bwd_ref_matches_torch_autograd(B, S, H, KH, D):
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _inputs(B, S, H, KH, D, 3 * S + D))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = RA.attention_ref(*leaves)
    want = torch.autograd.grad(out, leaves, dout)
    got = RA.attention_bwd_ref(q, k, v, out.detach(), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_cpu_wrappers_take_the_plain_versions():
    """On the host the model's attention is the plain version, which
    autograd differentiates, and the backward wrapper is
    ``attention_bwd_ref``; no kernel counter moves."""
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _inputs(2, 21, 4, 2, 8, 0))
    counts = (KA.launches, KA.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = L.blocked_causal_attention(*leaves)
    torch.testing.assert_close(out, RA.attention_ref(q, k, v), rtol=0,
                               atol=0)
    grads = torch.autograd.grad(out, leaves, dout)
    for g, w in zip(grads, KA.flash_attention_bwd(q, k, v, out.detach(),
                                                  dout)):
        torch.testing.assert_close(g, w, **TOL)
    assert (KA.launches, KA.bwd_launches) == counts


def _jax_lse2(q, k):
    """Base-2 log-sum-exp of each row's scores, formed as the JAX oracle
    ``attention_ref`` forms them (scaled, causal mask to -inf)."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, KH, H // KH, D)
    s = jnp.einsum("bskgd,btkd->bkgst", qg, jnp.asarray(k)) / math.sqrt(D)
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None, None], s,
                  -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1) / math.log(2.0)).reshape(
        B, H, S)


@pytest.mark.parametrize("B,S,H,KH,D", SHAPES)
def test_attention_lse_ref_matches_jax_logsumexp(B, S, H, KH, D):
    q, k, v, _ = _inputs(B, S, H, KH, D, 5 * S + H)
    got = RA.attention_lse_ref(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), _jax_lse2(q, k), **TOL)


@pytest.mark.parametrize("B,S,H,KH,D", SHAPES)
def test_attention_bwd_ref_with_lse_matches_without(B, S, H, KH, D):
    """P formed from the kept log-sum-exp, as the kernel forms it, gives
    the softmax's gradients."""
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _inputs(B, S, H, KH, D, 7 * S + D))
    out = RA.attention_ref(q, k, v)
    lse = RA.attention_lse_ref(q, k, v)
    got = RA.attention_bwd_ref(q, k, v, out, dout, lse=lse)
    want = RA.attention_bwd_ref(q, k, v, out, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_attention_bwd_ref_rejects_a_misshapen_lse():
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(1, 9, 4, 2, 8, 1))
    out = RA.attention_ref(q, k, v)
    lse = RA.attention_lse_ref(q, k, v)
    for bad in (lse[:, :, :-1], lse.transpose(1, 2), lse.double()):
        with pytest.raises(ValueError, match="lse"):
            RA.attention_bwd_ref(q, k, v, out, dout, lse=bad)


def test_cpu_backward_wrapper_takes_lse():
    """On the host ``flash_attention_bwd`` with the kept log-sum-exp is
    the plain version fed with it, and gives the plain gradients; no
    kernel counter moves."""
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _inputs(2, 21, 4, 2, 8, 3))
    out = RA.attention_ref(q, k, v)
    lse = RA.attention_lse_ref(q, k, v)
    counts = (KA.launches, KA.bwd_launches)
    got = KA.flash_attention_bwd(q, k, v, out, dout, lse)
    for g, fed, w in zip(got,
                         RA.attention_bwd_ref(q, k, v, out, dout, lse=lse),
                         RA.attention_bwd_ref(q, k, v, out, dout)):
        torch.testing.assert_close(g, fed, rtol=0, atol=0)
        torch.testing.assert_close(g, w, **TOL)
    assert (KA.launches, KA.bwd_launches) == counts


@pytest.mark.parametrize("B,S,H,KH", [
    pytest.param(1, 24, 4, 4, id="1-24-4"),
    pytest.param(2, 13, 2, 2, id="2-13-2"),
    # G = 2 (the card's tests run the kernel at (1, 129, 4, 2) against
    # this plain version, which has no tiles; past S ~ 70 at D = 192 the
    # float32 sums of either side round beyond the elementwise atol), and
    # S one past a 64-row tile
    pytest.param(1, 24, 4, 2, id="1-24-4-2"),
    pytest.param(2, 65, 2, 2, id="2-65-2-2"),
])
def test_attention_bwd_ref_at_mla_head_dim_matches_jax_vjp(B, S, H, KH):
    """MLA's training shapes: the core at head dim 192 (128 nope + 64
    rope), v of 128 columns zero-padded to 192 and the output sliced back,
    so the padded columns of dO are zero and their dV is dropped.  The
    plain backward against ``jax.vjp`` of the oracle, every column."""
    D, VD = 192, 128
    q, k, v, dout = _inputs(B, S, H, KH, D, 5 * S + H)
    v[..., VD:] = 0.0
    dout[..., VD:] = 0.0
    out, vjp = jax.vjp(JRA.attention_ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    np.testing.assert_array_equal(np.asarray(out)[..., VD:], 0.0)
    got = RA.attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(np.array(out)),
                               torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
