"""Causal attention with v narrower than q and k (MLA: head dim 192 for q
and k, 128 for v) in the port, on the CPU, against the JAX package, which
pads v to 192 with zeros and slices the output back
(``src/repro/models/layers.py`` ``mla_apply``).  The port's
``flash_attention`` and its plain versions take v at its own width: the
outputs and the gradients agree with ``blocked_causal_attention`` and
``jax.vjp`` of it at rtol/atol 2e-4 (``tests/test_torch_mla.py``'s
tolerance).  The planner's tally at (192, 128) and the widths the kernels
refuse are checked on ``meta`` tensors.  The CUDA kernel at (192, 128) is
held against the plain version in ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
from repro_torch.models import layers as L

TOL = dict(rtol=2e-4, atol=2e-4)
D, DV = 192, 128
CASES = [(B, S, H, KH) for B, S, H, KH in
         ((2, 50, 2, 2), (1, 64, 2, 2), (1, 96, 2, 2),     # G = 1
          (2, 50, 4, 2), (1, 64, 4, 2), (1, 96, 4, 2))]    # G = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch's intra-op pool small while this module runs (the suite
    runs files in parallel workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(B, S, H, KH, seed):
    """q (B,S,H,192), k (B,S,KH,192), v (B,S,KH,128), dout (B,S,H,128)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, DV),
                      (B, S, H, DV))]


def _jax_attention(q, k, v):
    """What the JAX package's MLA computes: v zero-padded to q's head
    dim, its blocked causal core (32-row blocks), sliced back."""
    vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - DV)))
    return JL.blocked_causal_attention(q, k, vp, 32)[..., :DV]


@pytest.mark.parametrize("B,S,H,KH", CASES)
def test_attention_at_v_width_128_matches_jax(B, S, H, KH):
    q, k, v, _ = _inputs(B, S, H, KH, S + 7 * H)
    want = np.asarray(_jax_attention(*map(jnp.asarray, (q, k, v))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = KA.flash_attention(tq, tk, tv)
    assert got.shape == (B, S, H, DV)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version takes v at its own width too
    np.testing.assert_allclose(RA.attention_ref(tq, tk, tv).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(
        L.blocked_causal_attention(tq, tk, tv, 32).numpy(), want, **TOL)


@pytest.mark.parametrize("B,S,H,KH", CASES)
def test_attention_grads_at_v_width_128_match_jax_vjp(B, S, H, KH):
    q, k, v, dout = _inputs(B, S, H, KH, 3 * S + H)
    _, vjp = jax.vjp(_jax_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = KA.flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    # the plain backward at D_v < D, as the CUDA wrapper's plain version
    plain = KA.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                   out.detach(), torch.from_numpy(dout))
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert g.shape == p.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **TOL)


def test_meta_tally_at_v_width_128():
    B, S, H, KH = 2, 100, 16, 16
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, KH, D, dtype=torch.bfloat16, device="meta")
    v = torch.empty(B, S, KH, DV, dtype=torch.bfloat16, device="meta")
    before = dict(KA.meta_cost.get("flash_attention",
                                   dict(calls=0, flops=0.0, bytes=0.0)))
    out, lse = KA.flash_attention_fwd(q, k, v, keep_lse=True)
    assert out.shape == (B, S, H, DV) and out.device.type == "meta"
    assert lse.shape == (B, H, S)
    got = KA.meta_cost["flash_attention"]
    assert got["calls"] == before["calls"] + 1
    ops = 2.0 * B * H * (D + DV) * S * (S + 1) / 2
    assert got["flops"] - before["flops"] == pytest.approx(ops, rel=1e-12)
    nbytes = 2 * B * S * (H * D + KH * D + KH * DV + H * DV) + 4 * B * H * S
    assert got["bytes"] - before["bytes"] == pytest.approx(nbytes,
                                                           rel=1e-12)
    dq, dk, dv = KA.flash_attention_bwd(q, k, v, out, out, lse)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


@pytest.mark.parametrize("d,dv,dtype", [
    *((d, dv, torch.bfloat16) for d, dv in ((192, 64), (128, 64),
                                            (128, 192), (64, 128),
                                            (192, 256))),
    *((d, dv, torch.float32) for d, dv in ((128, 192), (64, 128),
                                           (192, 256)))])
def test_check_refuses_widths_the_kernels_do_not_take(d, dv, dtype):
    """bfloat16 takes (D, D_v) in ``BF16_PAIRS`` only; no dtype takes
    D_v > D.  (float32 takes any D_v <= D: the FMA kernel masks v's and
    o's columns.)"""
    q = torch.empty(1, 8, 4, d, dtype=dtype, device="meta")
    k = torch.empty(1, 8, 4, d, dtype=dtype, device="meta")
    v = torch.empty(1, 8, 4, dv, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="D_v"):
        KA.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("d,dv,dtype", [
    (192, 128, torch.bfloat16), (192, 192, torch.bfloat16),
    (64, 64, torch.bfloat16), (192, 128, torch.float32),
    (24, 16, torch.float32)])
def test_check_takes_the_kernels_widths(d, dv, dtype):
    q = torch.empty(1, 8, 4, d, dtype=dtype, device="meta")
    k = torch.empty(1, 8, 2, d, dtype=dtype, device="meta")
    v = torch.empty(1, 8, 2, dv, dtype=dtype, device="meta")
    assert KA._check("t", q, k, v) == (1, 8, 4, 2, d, dv)
