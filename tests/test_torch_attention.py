"""The port's attention kernels on the CPU: the plain versions that the
wrappers ``flash_attention`` and ``flash_decode`` (and the model's
``blocked_causal_attention`` and ``cached_decode_attention``) take for a
CPU tensor, against the JAX package's Pallas kernels in interpret mode,
its oracles and its model path, at the shapes of ``tests/test_kernels.py``
plus a ragged S.  Inputs are made with numpy from a seed and handed to
both frameworks.  Tolerances are those of ``tests/test_kernels.py:120-124
,181-183``: float32 rtol 1e-4 / atol 2e-5, bfloat16 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JKA, ref as JRA
from repro.kernels.flash_decode import kernel as JKD, ref as JRD
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import kernel as KA, ops as OA
from repro_torch.kernels.flash_decode import kernel as KD, ops as OD
from repro_torch.models import layers as L

TOL = {"float32": dict(rtol=1e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs, so it does not starve the others'
    timing-sensitive threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# -------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,S,H,KH,D,bq,bk,dtype", [
    (2, 128, 4, 4, 64, 64, 64, "float32"),
    (1, 256, 8, 2, 64, 128, 64, "float32"),
    (2, 128, 8, 4, 80, 128, 32, "float32"),
    (1, 128, 4, 2, 64, 64, 64, "bfloat16"),
])
def test_flash_attention_plain_matches_jax(B, S, H, KH, D, bq, bk, dtype):
    rng = np.random.default_rng(S * H + D)
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.standard_normal(s), dtype)
        for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    ref = JRA.attention_ref(jq, jk, jv)
    pallas = JKA.flash_attention(jq, jk, jv, bq=bq, bk=bk, interpret=True)
    before = KA.launches
    got = KA.flash_attention(q, k, v)
    assert KA.launches == before          # a CPU tensor launches nothing
    assert got.dtype == q.dtype and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("S,chunk", [(100, 32), (257, 64), (96, 32)])
def test_blocked_causal_attention_matches_jax_any_s(S, chunk):
    """Ragged S: the JAX model falls back to one block when S % chunk;
    the port (plain version here, the kernel on a card) takes any S."""
    rng = np.random.default_rng(S)
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.standard_normal(s), "float32")
        for s in ((2, S, 8, 64), (2, S, 2, 64), (2, S, 2, 64)))
    want = JL.blocked_causal_attention(jq, jk, jv, chunk)
    got = L.blocked_causal_attention(q, k, v, chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(OA.attention(q, k, v, chunk=chunk)),
                               _np(JRA.attention_ref(jq, jk, jv)),
                               **TOL["float32"])


# ----------------------------------------------------------- flash decode
@pytest.mark.parametrize("B,S,H,KH,D,bk,pos", [
    (2, 256, 8, 4, 64, 64, 255),
    (1, 512, 4, 1, 128, 128, 300),     # masked tail inside a block
    (2, 256, 8, 8, 64, 256, 17),       # most blocks skipped
    (1, 128, 16, 2, 64, 32, 127),
    (2, 256, 8, 4, 64, 64, 63),        # the last key of a block
    (2, 256, 8, 4, 64, 64, 64),        # the first key of the next
    (1, 160, 8, 2, 80, 32, 95),
])
def test_flash_decode_plain_matches_jax(B, S, H, KH, D, bk, pos):
    rng = np.random.default_rng(pos + D)
    jq, q = _pair(rng.standard_normal((B, H, D)), "float32")
    jkc, kc = _pair(rng.standard_normal((B, S, KH, D)), "bfloat16")
    jvc, vc = _pair(rng.standard_normal((B, S, KH, D)), "bfloat16")
    ref = JRD.decode_attention_ref(jq, jkc, jvc, jnp.int32(pos))
    pallas = JKD.flash_decode(jq, jkc, jvc, jnp.int32(pos), bk=bk,
                              interpret=True)
    model = JL.cached_decode_attention(jq[:, None], jkc, jvc,
                                       jnp.int32(pos))[:, 0]
    before = KD.launches
    got = KD.flash_decode(q, kc, vc, pos)
    assert KD.launches == before and got.dtype == torch.float32
    for want in (ref, pallas, model):
        np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("pos", [0, 99, 100, 127])
def test_cached_decode_attention_matches_jax_model_path(pos):
    rng = np.random.default_rng(pos)
    jq, q = _pair(rng.standard_normal((2, 1, 8, 64)), "float32")
    jkc, kc = _pair(rng.standard_normal((2, 128, 4, 64)), "float32")
    jvc, vc = _pair(rng.standard_normal((2, 128, 4, 64)), "float32")
    want = JL.cached_decode_attention(jq, jkc, jvc, jnp.int32(pos))
    got = L.cached_decode_attention(q, kc, vc, pos)
    assert got.shape == (2, 1, 8, 64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(OD.decode_attention(q[:, 0], kc, vc,
                                                       pos)),
                               _np(want[:, 0]), **TOL["float32"])


@pytest.mark.parametrize("B,KH,pos,sms,want", [
    (4, 8, 287, 132, (1, 320)),          # the serving decode shape
    (128, 8, 32767, 132, (1, 32768)),    # decode_32k: one split per CTA
    (1, 1, 0, 132, (1, 64)),
    (2, 8, 4095, 132, (4, 1024)),
    (1, 8, 100000, 16, (2, 50048))])
def test_decode_splits_cover_exactly_the_live_keys(B, KH, pos, sms, want):
    ns, kps = KD.splits(B, KH, pos, sms)
    assert (ns, kps) == want and kps % KD.SPLIT_KEYS == 0
    assert (ns - 1) * kps <= pos < ns * kps    # no empty split, no gap


@pytest.mark.parametrize("B,KH,pos,sms", [
    (4, 8, 287, 132), (1, 1, 63, 132), (1, 1, 64, 132), (2, 2, 5000, 132),
    (1, 8, 65535, 132), (16, 8, 1023, 132), (3, 4, 777, 7)])
def test_decode_split_plan_reads_each_live_key_once(B, KH, pos, sms):
    """Every key of [0, pos] falls in exactly one split, every split has
    a live key, and a range is cut only while CTAs are fewer than SMs."""
    hc = KD.heads_per_cta(B, KH, sms)
    assert KH % hc == 0
    ns, kps = KD.splits(B, KH, pos, sms, hc)
    owners = np.zeros(pos + 1, np.int64)
    for s in range(ns):
        lo, hi = s * kps, min((s + 1) * kps, pos + 1)
        assert lo < hi                      # no empty CTA
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert ns * (B * KH // hc) <= max(sms, B * KH // hc)   # one wave


@pytest.mark.parametrize("B,KH,sms,want", [
    (4, 8, 132, 1),        # the serving decode shape: SMs to spare
    (128, 8, 132, 8),      # decode_32k: 128 CTAs of all 8 heads
    (64, 8, 132, 4), (33, 2, 132, 1), (99, 2, 132, 2), (7, 3, 4, 1)])
def test_decode_heads_per_cta_keeps_the_card_busy(B, KH, sms, want):
    hc = KD.heads_per_cta(B, KH, sms)
    assert hc == want and KH % hc == 0
    assert hc == 1 or 4 * B * KH // hc >= 3 * sms
