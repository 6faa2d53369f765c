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


# ------------------------------------------- attention kernels (serving)
def _attn_inputs(card, B, S, H, KH, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(card, dtype) for shape in ((B, S, H, D), (B, S, KH, D),
                                           (B, S, KH, D))]


# bfloat16 at rtol/atol 2e-2 and float32 at rtol 1e-4, atol 2e-5: the
# tolerances of tests/test_kernels.py:120-124
ATTN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 2e-5)}


@pytest.mark.parametrize("B,S,H,KH,D,dtype", [
    (2, 128, 4, 4, 64, torch.float32),
    (1, 256, 8, 2, 64, torch.float32),
    (1, 256, 4, 1, 128, torch.float32),
    (2, 128, 8, 4, 80, torch.float32),
    (1, 100, 8, 4, 64, torch.float32),        # ragged S
    (2, 1000, 32, 8, 64, torch.bfloat16),     # ragged S, llama3.2-1b heads
    (4, 256, 32, 8, 64, torch.bfloat16),      # the serving prefill shape
    (1, 200, 12, 2, 80, torch.bfloat16),      # G = 6
    (1, 130, 8, 8, 128, torch.bfloat16),
    (1, 77, 4, 2, 96, torch.float32),         # ragged S, unpadded D = 96
])
def test_flash_attention_kernel_matches_plain(card, B, S, H, KH, D, dtype):
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    q, k, v = _attn_inputs(card, B, S, H, KH, D, dtype, S + D)
    before = KA.launches
    got = KA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KA.launches == before + 1 and got.dtype == dtype
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), RA.attention_ref(q, k, v).float(),
                               rtol=rtol, atol=atol)


def test_flash_attention_kernel_rejects_bf16_head_dim_without_tile(card):
    from repro_torch.kernels.flash_attention import kernel as KA
    q, k, v = _attn_inputs(card, 1, 77, 4, 2, 96, torch.bfloat16, 0)
    before = KA.launches
    with pytest.raises(ValueError, match="bfloat16"):
        KA.flash_attention(q, k, v)
    assert KA.launches == before


@pytest.mark.parametrize("B,S,H,KH,D,pos,dtype", [
    (2, 256, 8, 4, 64, 255, torch.bfloat16),
    (1, 512, 4, 1, 128, 300, torch.bfloat16),   # masked tail of a block
    (2, 256, 8, 8, 64, 17, torch.bfloat16),     # most blocks never read
    (1, 128, 16, 2, 64, 127, torch.bfloat16),
    (4, 288, 32, 8, 64, 270, torch.bfloat16),   # the serving decode shape
    (2, 200, 12, 2, 80, 150, torch.bfloat16),   # G = 6, D = 80
    (2, 256, 8, 4, 64, 200, torch.float32),
    (1, 300, 8, 2, 80, 299, torch.float32),
    (1, 4096, 8, 1, 128, 4000, torch.float32),  # several splits
])
def test_flash_decode_kernel_matches_plain(card, B, S, H, KH, D, pos, dtype):
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    rng = np.random.default_rng(pos + D)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(card, dtype)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(
        np.float32)).to(card, dtype) for _ in range(2))
    before = KD.launches
    got = KD.flash_decode(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert KD.launches == before + 1 and got.dtype == dtype
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               RD.decode_attention(q, kc, vc, pos).float(),
                               rtol=rtol, atol=atol)
