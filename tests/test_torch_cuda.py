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
from repro_torch.kernels.mandelbrot import kernel as KM, ops as OM
from repro_torch.kernels.mandelbrot import ref as RM
from repro_torch.kernels.nbody import kernel as KN, ops as ON, ref as RN
from repro_torch.kernels.ray import ops as ORay, ref as RRay

pytestmark = pytest.mark.cuda
# card packets against host packets: those of tests/test_kernels.py
TOL = {"gaussian": (1e-5, 1e-5), "binomial": (1e-4, 1e-3),
       "nbody": (2e-4, 2e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


@pytest.mark.parametrize("n", [1, 33, 1024])
@pytest.mark.parametrize("steps", [1, 2, 31, 32, 63, 64, 95, 96, 127, 128,
                                   159, 160, 191, 192, 223, 224, 254, 255])
def test_binomial_kernel_matches_plain(card, steps, n):
    """Both sides of every re-pack of the register lattice (a front of
    32*w nodes is re-packed to w nodes a lane), the compile-time 254 steps
    and the run-time path, and option counts that leave a CTA's warps
    idle."""
    s0, k0, ty = (torch.from_numpy(x).to(card)
                  for x in OB.make_inputs(n, seed=2))
    before = KB.launches
    got = KB.price_options(s0, k0, ty, steps=steps)
    assert KB.launches == before + 1
    torch.testing.assert_close(got, RB.price_options(s0, k0, ty, steps=steps),
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


@pytest.mark.parametrize("iters", [1, 7, 8, 9, 15, 16, 17, 257, 5000])
def test_mandelbrot_kernel_exact_across_blocks(card, iters):
    """Iteration counts below, at and across a block of 16 unchecked steps,
    on a tile across the set's edge (counts of every size) whose width is
    not a multiple of a warp's 32 columns."""
    args = (24, 16, 128, 64, iters, 30, 45)
    got = KM.escape_counts(*args, device=card)
    assert torch.equal(got, RM.escape_counts(*args, device=card))
    assert torch.equal(got.cpu(), RM.escape_counts(*args))
    if iters >= 257:
        assert int(got.min()) < 8 and int(got.max()) == iters


@pytest.mark.parametrize("row0,col0,iters,want", [
    (28, 36, 300, 300),     # inside the main cardioid: every pixel maxes out
    (0, 0, 5000, 1)])       # a corner where |c| > 2: one step each
def test_mandelbrot_kernel_uniform_tiles(card, row0, col0, iters, want):
    args = (row0, 8, 64, 64, iters, col0, 8)
    got = KM.escape_counts(*args, device=card)
    assert torch.equal(got, torch.full_like(got, want))
    assert torch.equal(got.cpu(), RM.escape_counts(*args))


def _gaussian_inputs(card, h, w, ksize, seed):
    img = np.random.default_rng(seed).standard_normal((h, w)).astype(
        np.float32)
    return (torch.from_numpy(x).to(card) for x in OG.prepare(img, ksize))


@pytest.mark.parametrize("ksize,h,w,row0,n_rows", [
    (31, 512, 200, 128, 256),
    (31, 96, 300, 17, 1),          # one row
    (31, 96, 130, 5, 33),          # a tile and a row; 2 columns past 128
    (31, 300, 257, 40, 256),       # an odd width: scalar stores
    (5, 128, 200, 7, 100),         # run-time K
    (63, 128, 190, 3, 81)])
def test_gaussian_kernel_matches_plain(card, ksize, h, w, row0, n_rows):
    """The compile-time 31 taps and the run-time-K instance, at row counts
    and widths that leave partial tiles of 40 rows and 128 columns."""
    ip, wt = _gaussian_inputs(card, h, w, ksize, h + w + ksize)
    before = KG.launches
    got = KG.blur_rows(ip, wt, row0, n_rows)
    assert KG.launches == before + 1 and got.shape == (n_rows, w)
    torch.testing.assert_close(got, RG.blur_rows_ref(ip, wt, row0, n_rows),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ksize,row0,n_rows,col0,n_cols", [
    (31, 16, 48, 0, 40), (31, 0, 128, 77, 51), (31, 9, 40, 1, 256),
    (5, 3, 61, 10, 1)])
def test_gaussian_kernel_column_window(card, ksize, row0, n_rows, col0,
                                       n_cols):
    """A tile (row0, n_rows) x (col0, n_cols): the plain version on the
    window's padded columns, and the same columns of the full rows."""
    ip, wt = _gaussian_inputs(card, 128, 320, ksize, ksize + col0)
    got = KG.blur_rows(ip, wt, row0, n_rows, col0, n_cols)
    assert got.shape == (n_rows, n_cols)
    want = RG.blur_rows_ref(ip[:, col0:col0 + n_cols + ksize - 1], wt, row0,
                            n_rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got, KG.blur_rows(ip, wt, row0, n_rows)[:, col0:col0 + n_cols],
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row0,n_rows,col0,n_cols", [
    (32, 96, 1056, 4000), (0, 40, 33, 77), (200, 1, 1, 1023)])
def test_run_region_tiles_launch_the_kernels(card, row0, n_rows, col0,
                                             n_cols):
    """The 2-D programs' tile entries at widths that are no multiple of a
    CTA's or a warp's columns, with col0 != 0: one launch each, the
    Gaussian within 1e-5 of the plain version on the window's padded
    columns, the Mandelbrot counts equal to it."""
    ip, wt = _gaussian_inputs(card, 256, 5120, 31, 5)
    before = KG.launches
    got = OG.run_region(ip, wt, row0, n_rows, col0, n_cols)
    assert KG.launches == before + 1 and got.shape == (n_rows, n_cols)
    torch.testing.assert_close(got, RG.blur_rows_ref(
        ip[:, col0:col0 + n_cols + 30], wt, row0, n_rows),
        rtol=1e-5, atol=1e-5)
    before = KM.launches
    got = OM.run_region(row0, n_rows, col0, n_cols, width=5120,
                        height=256, max_iter=300, device=card)
    assert KM.launches == before + 1 and got.shape == (n_rows, n_cols)
    assert torch.equal(got, RM.escape_counts(row0, n_rows, 5120, 256, 300,
                                             col0, n_cols, device=card))


@pytest.mark.parametrize("which", [1, 2])
def test_banded_ray_packet_on_card_matches_host(card, monkeypatch, which):
    """A packet of the paper's 4,096-px image rendered on the card in
    bands of rows equals the host's, bit for bit: every operation of the
    plain version rounds to nearest on both devices (dot products added
    in a fixed order, the pixel coordinates computed on the host, a
    correctly rounded square root on each)."""
    scene = RRay.make_scene(which)
    on_card = {k: torch.from_numpy(v).to(card) for k, v in scene.items()}
    on_host = {k: torch.from_numpy(v) for k, v in scene.items()}
    got = ORay.run_range(on_card, 500, 40, width=4096, height=4096)
    assert ORay._band_rows(4096, 32) < 160       # banded at this size
    want = ORay.run_range(on_host, 500, 40, width=4096, height=4096)
    assert torch.equal(got.cpu(), want)
    # a tile with col0 != 0 in one band, and in bands of 3 rows
    whole = ORay.run_region(on_card, 2000, 20, 1000, 700, width=4096,
                            height=4096)
    monkeypatch.setattr(ORay, "BAND_ELEMS", 3 * 700 * 32 * 3)
    assert torch.equal(whole, ORay.run_region(on_card, 2000, 20, 1000, 700,
                                              width=4096, height=4096))


@pytest.mark.parametrize("name,kw", [
    ("gaussian2d", dict(h=512, w=480, lws=(32, 32))),
    ("mandelbrot2d", dict(px=256, max_iter=256)),
    ("ray1", dict(px=256)), ("ray2_2d", dict(px=256))])
def test_2d_and_ray_programs_on_card_and_host(card, name, kw):
    devices = [DeviceGroup("cuda0", device=card),
               DeviceGroup("cpu", device="cpu")]
    res = coexec(P.PROGRAMS[name](**kw), devices, powers=[50.0, 1.0])
    ref = P.reference_output(name, device=card, **kw)
    assert res.aborted_devices == 0 and devices[0].packets_done > 0
    if name.startswith(("mandelbrot", "ray")):
        # ray rounds alike on both devices (its plain version's design)
        np.testing.assert_array_equal(res.output, ref)
    else:
        np.testing.assert_allclose(res.output, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,tgt0,n_tgt", [
    (1024, 192, 320),
    (1000, 0, 1), (1000, 999, 1),          # N not a multiple of the tile
    (1000, 17, 64), (1000, 680, 320),      # the last packet ends at N
    (2048, 5, 320), (2048, 100, 1), (2048, 1984, 64),
    (300, 10, 64),                         # slices past N stay empty
    (5000, 4680, 320)])                    # a short last slice
def test_nbody_kernel_matches_plain(card, n, tgt0, n_tgt):
    """Target counts that are not a multiple of a thread's or a CTA's
    targets, and source counts that are not a multiple of the tile or of
    the warps' slices."""
    pm, vel = (torch.from_numpy(x).to(card) for x in ON.make_inputs(n))
    before = KN.launches
    got = KN.step_rows(pm, vel, tgt0, n_tgt)
    assert KN.launches == before + 1
    torch.testing.assert_close(got, RN.step_rows(pm, vel, tgt0, n_tgt),
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


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("G", [1, 4, 6, 8])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 4096])
def test_flash_attention_bf16_tiles_and_edges(card, S, G, D):
    """The wgmma kernel across its 128-row CTA and its 128-key K/V tile
    (S = 127, 128, 129), one position, a long causal range, every G of
    the dense configs and G = 6 (idle rows), every bfloat16 head dim."""
    from repro_torch.kernels.flash_attention import kernel as KA, ref as RA
    B = 1 if S == 4096 else 2
    q, k, v = _attn_inputs(card, B, S, 2 * G, 2, D, torch.bfloat16,
                           S * 7 + G * 3 + D)
    before = KA.launches
    got = KA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KA.launches == before + 1 and got.dtype == torch.bfloat16
    want = RA.attention_ref(q, k, v).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


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


def _decode_inputs(card, B, S, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(card, torch.bfloat16)
    kc, vc = (torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(
        np.float32)).to(card, torch.bfloat16) for _ in range(2))
    return q, kc, vc


@pytest.mark.parametrize("B,S,KH,D,pos,one_split", [
    (64, 512, 8, 64, 511, True),    # B*KH fills the card: one split
    (128, 300, 8, 64, 299, True),   # 8 kv heads a CTA
    (96, 200, 4, 128, 150, True),   # 2 kv heads a CTA, D = 128
    (2, 4096, 8, 64, 4095, False),  # 4 splits merged by the last CTA
    (3, 64, 8, 64, 0, None),        # pos = 0: one key
    (1, 300, 2, 128, 0, None),
    (2, 300, 2, 96, 200, None),     # a head dim of no model: generic path
    (2, 300, 4, 72, 299, None),     # D not a multiple of 16
])
def test_flash_decode_one_launch_any_split_count(card, B, S, KH, D, pos,
                                                 one_split):
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    ns, _ = KD.splits(B, KH, pos, sms, KD.heads_per_cta(B, KH, sms))
    if one_split is not None:
        assert (ns == 1) == one_split
    q, kc, vc = _decode_inputs(card, B, S, 4 * KH, KH, D, B + S + pos)
    before = KD.launches
    got = KD.flash_decode(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert KD.launches == before + 1
    torch.testing.assert_close(got.float(),
                               RD.decode_attention(q, kc, vc, pos).float(),
                               rtol=2e-2, atol=2e-2)


def test_flash_decode_counters_reset_between_calls(card):
    """Ten calls in a row alternating two shapes of different B*KH, each
    with several splits: a counter left non-zero by one call would make
    the next call's merge run early (or never) and give wrong rows."""
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    shapes = [(2, 2048, 8, 1999), (5, 4096, 4, 3000)]
    inputs = [_decode_inputs(card, B, S, 4 * KH, KH, 64, i)
              for i, (B, S, KH, _) in enumerate(shapes)]
    wants = [RD.decode_attention(q, kc, vc, shapes[i][3]).float()
             for i, (q, kc, vc) in enumerate(inputs)]
    for call in range(10):
        i = call % 2
        q, kc, vc = inputs[i]
        got = KD.flash_decode(q, kc, vc, shapes[i][3])
        torch.testing.assert_close(got.float(), wants[i], rtol=2e-2,
                                   atol=2e-2)


def test_flash_decode_on_two_streams_at_once(card):
    """Two calls in flight on two streams: each stream has counters of
    its own, so their merges cannot count each other's splits."""
    from repro_torch.kernels.flash_decode import kernel as KD, ref as RD
    args = [_decode_inputs(card, 4, 8192, 8, 2, 128, 10 + i) + (8000 - i,)
            for i in range(2)]
    wants = [RD.decode_attention(*a).float() for a in args]
    streams = [torch.cuda.Stream(card) for _ in args]
    torch.cuda.synchronize()
    outs = []
    for st, a in zip(streams, args):
        with torch.cuda.stream(st):
            outs.append(KD.flash_decode(*a))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


# --------------------------------------------- selective scan (Mamba1)
# rtol 1e-4 / atol 1e-5: the tolerance of tests/test_kernels.py:152
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,S,di,ds,with_h0", [
    (1, 64, 32, 8, False),          # the shapes of tests/test_kernels.py
    (2, 128, 64, 16, False),
    (2, 96, 48, 16, False),
    (1, 1000, 1000, 8, True),       # ragged S and di, a carried state
    (2, 37, 100, 5, True),          # ds not a power of two
    (1, 19, 64, 32, False),         # a whole warp per channel
    (3, 8, 33, 1, True),
    (2, 0, 16, 16, True),           # no steps: h_T is h0
])
def test_selective_scan_kernel_matches_plain(card, B, S, di, ds, with_h0):
    from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS
    rng = np.random.default_rng(S + di + ds)
    a, b, C, h0 = (torch.from_numpy(x.astype(np.float32)).to(card) for x in (
        rng.uniform(0.5, 0.99, (B, S, di, ds)),
        rng.standard_normal((B, S, di, ds)) * 0.1,
        rng.standard_normal((B, S, ds)),
        rng.standard_normal((B, di, ds))))
    h0 = h0 if with_h0 else None
    before = KS.launches
    y, h = KS.selective_scan(a, b, C, h0)
    torch.cuda.synchronize()
    assert KS.launches == before + 1
    yr, hr = RS.selective_scan(a, b, C, h0)
    torch.testing.assert_close(y, yr, **SCAN_TOL)
    torch.testing.assert_close(h, hr, **SCAN_TOL)


def test_selective_scan_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.mamba_scan import kernel as KS
    a = torch.rand((1, 4, 8, 33), device=card)
    C = torch.rand((1, 4, 33), device=card)
    before = KS.launches
    with pytest.raises(ValueError, match="ds=33"):
        KS.selective_scan(a, a, C)
    with pytest.raises(TypeError):
        KS.selective_scan(a.double(), a.double(), C.double())
    with pytest.raises(ValueError, match="contiguous"):
        KS.selective_scan(a[..., :16], a[..., :16], C[..., :16])
    assert KS.launches == before


def test_mamba_model_on_card_matches_host(card):
    """The smoke falcon-mamba-7b in float32 (TF32 off): prefill through
    the scan kernel (one launch per layer) and decode steps in plain ops
    (no launch), against the same weights on the host."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.mamba_scan import kernel as KS
    from repro_torch.models import transformer as T
    cfg = get_smoke("falcon-mamba-7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int64))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def run(device, p):
        t = toks.to(device)
        cache = T.init_cache(cfg, 2, 24, device=device)
        lg, cache = T.prefill(cfg, p, t[:, :20], cache)
        outs = [lg[:, 0]]
        for i in range(20, 24):
            lg, cache = T.decode_step(cfg, p, t[:, i:i + 1], cache, i)
            outs.append(lg[:, 0])
        return torch.stack(outs, 1).cpu()

    try:
        host = run("cpu", params)
        before = KS.launches
        got = run(card, params.to(card))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert KS.launches == before + cfg.n_layers
    torch.testing.assert_close(got, host, rtol=2e-4, atol=2e-4)
