"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, and the main path on ``[cuda:0, cpu]``.  Marked
``cuda``: each test skips on a host without a card.  Run them on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import coexec
from repro_torch.core import programs as P
from repro_torch.core.device import DeviceGroup
from repro_torch.kernels.binomial import kernel as KB, ops as OB, ref as RB
from repro_torch.kernels.gaussian import kernel as KG, ops as OG, ref as RG
from repro_torch.kernels.mandelbrot import kernel as KM, ref as RM
from repro_torch.kernels.nbody import kernel as KN, ops as ON, ref as RN

pytestmark = pytest.mark.cuda
# card packets against host packets: those of tests/test_kernels.py
TOL = {"gaussian": (1e-5, 1e-5), "binomial": (1e-4, 1e-3),
       "nbody": (2e-4, 2e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def test_binomial_kernel_matches_plain(card):
    s0, k0, ty = (torch.from_numpy(x).to(card)
                  for x in OB.make_inputs(1024, seed=2))
    before = KB.launches
    got = KB.price_options(s0, k0, ty)
    assert KB.launches == before + 1
    torch.testing.assert_close(got, RB.price_options(s0, k0, ty),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("row0,n_rows,w,h,iters,col0,n_cols", [
    (0, 64, 64, 64, 64, 0, 0), (40, 40, 256, 128, 500, 16, 100)])
def test_mandelbrot_kernel_is_exact(card, row0, n_rows, w, h, iters, col0,
                                    n_cols):
    got = KM.escape_counts(row0, n_rows, w, h, iters, col0, n_cols,
                           device=card)
    plain_card = RM.escape_counts(row0, n_rows, w, h, iters, col0, n_cols,
                                  device=card)
    plain_host = RM.escape_counts(row0, n_rows, w, h, iters, col0, n_cols)
    assert torch.equal(got, plain_card)
    assert torch.equal(got.cpu(), plain_host)


def test_gaussian_kernel_matches_plain(card):
    img = np.random.default_rng(3).standard_normal((512, 200)).astype(
        np.float32)
    ip, w = (torch.from_numpy(x).to(card) for x in OG.prepare(img))
    got = KG.blur_rows(ip, w, 128, 256)
    torch.testing.assert_close(got, RG.blur_rows_ref(ip, w, 128, 256),
                               rtol=1e-5, atol=1e-5)


def test_nbody_kernel_matches_plain(card):
    pm, vel = (torch.from_numpy(x).to(card) for x in ON.make_inputs(1024))
    got = KN.step_rows(pm, vel, 192, 320)
    torch.testing.assert_close(got, RN.step_rows(pm, vel, 192, 320),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,kw", [
    ("gaussian", dict(h=1024, w=256)), ("binomial", dict(n_options=16384)),
    ("mandelbrot", dict(px=256, max_iter=256)),
    ("nbody", dict(n_bodies=2048))])
def test_coexec_on_card_and_host(card, name, kw):
    devices = [DeviceGroup("cuda0", device=card),
               DeviceGroup("cpu", device="cpu")]
    res = coexec(P.PROGRAMS[name](**kw), devices, powers=[50.0, 1.0])
    ref = P.reference_output(name, device=card, **kw)
    assert res.aborted_devices == 0 and not devices[0].dead
    assert devices[0].packets_done > 0
    if name == "mandelbrot":
        np.testing.assert_array_equal(res.output, ref)
    else:
        rtol, atol = TOL[name]
        np.testing.assert_allclose(res.output, ref, rtol=rtol, atol=atol)
