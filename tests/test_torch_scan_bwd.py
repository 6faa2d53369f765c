"""The scan's gradient on the CPU: the port's plain backward
``selective_scan_bwd_ref`` (the plain version of the CUDA backward
kernel) against ``jax.vjp`` of the JAX package's oracle
``kernels/mamba_scan/ref.py::selective_scan_ref`` and of its model scan
``models/layers.py::_ssm_scan_chunked`` (chunked associative scan), and
against autograd through the port's plain ``selective_scan``, which CPU
tensors take in training.  Inputs are made with numpy from a seed.

Tolerance rtol 1e-5 / atol 1e-6: both sides run the recurrence in float32,
in other orders of operations (the chunked scan's prefix products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as JRS
from repro.models import layers as JL
from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS

TOL = dict(rtol=1e-5, atol=1e-6)
DI = 6
JAX_CHUNK = 16         # S = 100 is not a multiple of it: one whole chunk


def _inputs(S, ds, nonzero, seed):
    """a in [0.5, 0.99), b small, C, dy standard normal; h0 and dhT
    standard normal, or zeros."""
    rng = np.random.default_rng(seed)
    B = 2
    arrays = dict(
        a=rng.uniform(0.5, 0.99, (B, S, DI, ds)),
        b=rng.standard_normal((B, S, DI, ds)) * 0.1,
        C=rng.standard_normal((B, S, ds)),
        dy=rng.standard_normal((B, S, DI)),
        h0=rng.standard_normal((B, DI, ds)) if nonzero
        else np.zeros((B, DI, ds)),
        dhT=rng.standard_normal((B, DI, ds)) if nonzero
        else np.zeros((B, DI, ds)))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _port(x, nonzero):
    """The plain backward; zero h0 and dhT passed as None."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    h0, dhT = (t["h0"], t["dhT"]) if nonzero else (None, None)
    return RS.selective_scan_bwd_ref(t["a"], t["b"], t["C"], h0, t["dy"],
                                     dhT)


def _jax(fn, x):
    _, vjp = jax.vjp(fn, *(jnp.asarray(x[k]) for k in ("a", "b", "C",
                                                        "h0")))
    return vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dhT"])))


JAX_SCANS = {
    "oracle": lambda a, b, C, h0: JRS.selective_scan_ref(a, b, C, h0),
    "chunked": lambda a, b, C, h0: JL._ssm_scan_chunked(a, b, C, h0,
                                                        JAX_CHUNK),
}


@pytest.mark.parametrize("nonzero", [False, True],
                         ids=["zero-h0-dhT", "h0-dhT"])
@pytest.mark.parametrize("ds", [1, 16, 32])
@pytest.mark.parametrize("S", [1, 7, 64, 100])
@pytest.mark.parametrize("scan", sorted(JAX_SCANS))
def test_plain_backward_matches_jax_vjp(scan, S, ds, nonzero):
    x = _inputs(S, ds, nonzero, seed=S * 100 + ds)
    got = _port(x, nonzero)
    want = _jax(JAX_SCANS[scan], x)
    for name, g, w in zip(("da", "db", "dC", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("nonzero", [False, True],
                         ids=["zero-h0-dhT", "h0-dhT"])
@pytest.mark.parametrize("S,ds", [(1, 16), (7, 1), (64, 16), (100, 32)])
def test_plain_backward_matches_autograd_of_plain_scan(S, ds, nonzero):
    """What training takes on the host (autograd through the plain scan)
    and the plain version of the kernel give one gradient; dhT None is
    a zero cotangent of h_T."""
    x = _inputs(S, ds, nonzero, seed=7 * S + ds)
    t = {k: torch.from_numpy(v).requires_grad_(k in ("a", "b", "C", "h0"))
         for k, v in x.items()}
    y, h = RS.selective_scan(t["a"], t["b"], t["C"], t["h0"])
    grads = torch.autograd.grad((y * t["dy"]).sum() + (h * t["dhT"]).sum(),
                                (t["a"], t["b"], t["C"], t["h0"]))
    got = _port(x, nonzero)
    for name, g, w in zip(("da", "db", "dC", "dh0"), got, grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


def test_wrapper_takes_the_plain_backward_on_the_host():
    """``selective_scan_bwd`` on CPU tensors is the plain version, and
    launches nothing."""
    x = _inputs(9, 4, True, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    before = KS.bwd_launches, KS.launches
    got = KS.selective_scan_bwd(t["a"], t["b"], t["C"], t["h0"], t["dy"],
                                t["dhT"])
    want = RS.selective_scan_bwd_ref(t["a"], t["b"], t["C"], t["h0"],
                                     t["dy"], t["dhT"])
    assert (KS.bwd_launches, KS.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_empty_sequence_passes_dhT_to_dh0():
    x = _inputs(0, 4, True, seed=4)
    da, db, dC, dh0 = _port(x, True)
    assert da.shape == (2, 0, DI, 4) and dC.shape == (2, 0, 4)
    np.testing.assert_array_equal(dh0.numpy(), x["dhT"])
