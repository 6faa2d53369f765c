"""The gradient of causal GQA attention in the port, on the CPU: the
plain version of the backward kernel (``attention_bwd_ref``, the
explicit formulas with P materialised) against ``jax.vjp`` of the JAX
package's oracle ``kernels/flash_attention/ref.py`` ``attention_ref`` and
against torch autograd of the port's ``attention_ref``, in float32 at
rtol 1e-5 / atol 1e-6.  The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``."""
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
