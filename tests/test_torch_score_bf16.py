"""bfloat16 attention scores and the query offset against the JAX
package, on the CPU.

* ``attention_ref`` at ``score_dtype`` "bfloat16" against the JAX
  package's ``blocked_causal_attention`` with ``jnp.bfloat16`` scores,
  forward and ``jax.vjp`` gradient, at S = 128 with chunks of 64 and 128,
  G = 1, 4 and 7, and D = 64, 80 and MLA's 192 with v at 128; and
  ``attention_bwd_ref`` (the backward kernel's plain version, P formed
  from the rounded scores and the kept log-sum-exp) against the same
  gradient.  Tolerance rtol = atol = 2e-2, ``tests/test_kernels.py``'s
  bfloat16 tolerance.
* ``q_start``: the rectangle's rows equal the matching rows of the full
  causal attention, of its log-sum-exp and of its gradient (float32,
  rtol 1e-5, atol 1e-6), at both score dtypes; the wrapper's shape
  checks and the planner's costs of the rectangle.
* Whole models with ``score_dtype`` "bfloat16" (the smoke llama3.2-1b,
  deepseek-v2-lite-16b and jamba-v0.1-52b, float32 weights): prefill and
  teacher-forced decode logits, the loss, every gradient and one
  ``make_train_step`` against the JAX package's, at the float32 tests'
  checks loosened to bfloat16's 2e-2 where the scores enter (every
  logit and gradient).
"""
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.models.layers import blocked_causal_attention as jax_attention
from repro.optim import adamw as JA
from repro.training import step as JS
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.optim.adamw import OptConfig
from repro_torch.training import step as S

BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=1e-5, atol=1e-6)
S_LEN = 128
# (D, D_v): the dense head dims and MLA's
WIDTHS = [(64, 64), (80, 80), (192, 128)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _qkv(G, D, DV, seed, S=S_LEN, B=2, KH=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KH * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, DV)).astype(np.float32)
    return q, k, v


def _jax_bf16(q, k, v, chunk):
    """The JAX package's bfloat16-score attention and its vjp, v padded to
    D and the output sliced back as ``mla_apply`` does."""
    D, DV = q.shape[-1], v.shape[-1]
    vp = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - DV)))

    def f(q, k, vp):
        return jax_attention(q, k, vp, chunk, jnp.bfloat16)[..., :DV]
    out, vjp = jax.vjp(f, q, k, vp)
    do = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    dq, dk, dvp = vjp(jnp.asarray(do))
    return (np.asarray(out, np.float32), do,
            [np.asarray(g, np.float32) for g in (dq, dk, dvp[..., :DV])])


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("D,DV", WIDTHS)
def test_attention_ref_bf16_matches_jax(chunk, G, D, DV):
    q, k, v = _qkv(G, D, DV, seed=G * 1000 + D)
    want, do, grads = _jax_bf16(q, k, v, chunk)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = K.flash_attention(tq, tk, tv, score_dtype="bfloat16", chunk=chunk)
    np.testing.assert_allclose(out.detach().numpy(), want, **BF16)
    out.backward(torch.from_numpy(do))
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), g, **BF16)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("D,DV", WIDTHS)
def test_attention_bwd_ref_bf16_matches_jax(chunk, D, DV):
    """The backward kernel's plain version, from the chunk loop's
    log-sum-exp, against ``jax.vjp`` of the bfloat16 scores."""
    q, k, v = _qkv(4, D, DV, seed=7 + D)
    want, do, grads = _jax_bf16(q, k, v, chunk)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = R.attention_lse_ref(tq, tk, tv, score_dtype="bfloat16",
                              chunk=chunk)
    got = K.flash_attention_bwd(tq, tk, tv, torch.tensor(want),
                                torch.from_numpy(do), lse,
                                score_dtype="bfloat16")
    for t, g in zip(got, grads):
        np.testing.assert_allclose(t.numpy(), g, **BF16)


def test_bf16_lse_is_the_rounded_scores():
    """The chunk loop's log-sum-exp equals that of the bfloat16 scores
    (the rounding of p moves it by bfloat16 steps only)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 64, 64, seed=3))
    lse = R.attention_lse_ref(q, k, v, score_dtype="bfloat16", chunk=64)
    s = R._scores(q, k, bf16=True)                 # (B, KH, G, S, S)
    want = torch.logsumexp(s, dim=-1).reshape(2, 8, S_LEN) * R.LOG2E
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **BF16)


# ------------------------------------------------ the kernels' schedule
@pytest.mark.parametrize("S", [128, 100])
def test_ragged_chunks_round_as_the_kernels_tiles(S):
    """``chunk`` with ``ragged`` (the plain version of the kernels' key
    tiles): where 64 divides the keys it is the JAX schedule bit for bit;
    at 100 keys the last chunk is short, and the rows are those of the
    JAX package's 128-key attention chunked by 64 (rows before 100 see
    no later key), where the JAX schedule itself would take all 100 keys
    as one chunk."""
    q, k, v = _qkv(4, 64, 64, seed=S)
    kw = dict(score_dtype="bfloat16", chunk=64)
    tq, tk, tv = (torch.from_numpy(x[:, :S]) for x in (q, k, v))
    got = R.attention_ref(tq, tk, tv, ragged=True, **kw)
    lse = R.attention_lse_ref(tq, tk, tv, ragged=True, **kw)
    whole = R.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    wlse = R.attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               **kw)
    np.testing.assert_allclose(got.numpy(), whole[:, :S].numpy(), **F32)
    np.testing.assert_allclose(lse.numpy(), wlse[..., :S].numpy(), **F32)
    want = np.asarray(jax_attention(q, k, v, 64, jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got.numpy(), want[:, :S], **BF16)
    one = R.attention_ref(tq, tk, tv, **kw)
    if S % 64 == 0:
        assert torch.equal(got, one)
    else:   # the JAX schedule's one chunk rounds p against another max
        assert not torch.equal(got, one)


def test_bf16_products_round_p_and_ds():
    """``bf16_products`` (the bfloat16 kernels' operands of ``wgmma``):
    dv is P rounded to bfloat16 times dO, and the gradient stays within
    bfloat16's tolerance of ``jax.vjp`` and of the unrounded one, apart
    from it."""
    q, k, v = _qkv(4, 64, 64, seed=21)
    want, do, grads = _jax_bf16(q, k, v, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(score_dtype="bfloat16", chunk=64)
    lse = R.attention_lse_ref(tq, tk, tv, **kw)
    args = (tq, tk, tv, torch.tensor(want), torch.from_numpy(do), lse)
    got = R.attention_bwd_ref(*args, bf16_products=True, **kw)
    plain = R.attention_bwd_ref(*args, **kw)
    for t, g, u in zip(got, grads, plain):
        np.testing.assert_allclose(t.numpy(), g, **BF16)
        np.testing.assert_allclose(t.numpy(), u.numpy(), **BF16)
        assert not torch.equal(t, u)
    p = torch.exp2(R._scores(tq, tk, bf16=True) * R.LOG2E
                   - lse.reshape(2, 2, 4, S_LEN, 1))
    dv = torch.einsum("bkgst,bskgd->btkd", p.to(torch.bfloat16).float(),
                      torch.from_numpy(do).reshape(2, S_LEN, 2, 4, 64))
    np.testing.assert_allclose(got[2].numpy(), dv.numpy(), **F32)


# ------------------------------------------------------------ q_start
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_start", [0, 1, 64, 100])
@pytest.mark.parametrize("D,DV", [(64, 64), (192, 128)])
def test_q_start_rows_match_the_full_attention(score_dtype, q_start, D,
                                               DV):
    """Rows q_start ... of the full causal attention (and of its
    log-sum-exp and gradient, with the rows before q_start given no
    gradient) from the rectangle of those rows against every key up to
    them.  At bfloat16 the query blocks are the chunks at global
    positions, so the rectangle's rows are the full attention's bit for
    bit there too when q_start falls on a chunk; elsewhere they agree to
    bfloat16's tolerance."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, D, DV, seed=q_start))
    kw = dict(score_dtype=score_dtype, chunk=64)
    tol = F32 if score_dtype == "float32" or q_start % 64 == 0 else BF16
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, S_LEN, 8, DV)).astype(np.float32))
    do[:, :q_start] = 0
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    full = R.attention_ref(qa, ka, va, **kw)
    full.backward(do)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    part = R.attention_ref(qb[:, q_start:], kb, vb, q_start=q_start, **kw)
    part.backward(do[:, q_start:])
    np.testing.assert_allclose(part.detach().numpy(),
                               full[:, q_start:].detach().numpy(), **tol)
    for a, b in ((qb, qa), (kb, ka), (vb, va)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **tol)
    lse = R.attention_lse_ref(q[:, q_start:], k, v, q_start=q_start, **kw)
    np.testing.assert_allclose(
        lse.numpy(), R.attention_lse_ref(q, k, v, **kw)[..., q_start:],
        **tol)
    # the backward kernel's plain version from the kept log-sum-exp: the
    # rectangle's against the full attention's
    got = R.attention_bwd_ref(q[:, q_start:], k, v, part.detach(),
                              do[:, q_start:], lse, q_start=q_start,
                              score_dtype=score_dtype)
    whole = R.attention_bwd_ref(q, k, v, full.detach(), do,
                                R.attention_lse_ref(q, k, v, **kw),
                                score_dtype=score_dtype)
    for a, b in zip(got, (whole[0][:, q_start:],) + whole[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def test_q_start_shapes_are_checked():
    q = torch.zeros(1, 8, 4, 64, device="meta")
    k = v = torch.zeros(1, 24, 2, 64, device="meta")
    assert K._check("t", q, k, v, q_start=16) == (1, 8, 4, 2, 64, 64)
    with pytest.raises(ValueError, match="q_start 8"):
        K._check("t", q, k, v, q_start=8)
    with pytest.raises(ValueError, match="keys 24"):
        R.attention_ref(torch.zeros(q.shape), torch.zeros(k.shape),
                        torch.zeros(v.shape), q_start=8)
    with pytest.raises(ValueError, match="score_dtype"):
        K.flash_attention(q, k, v, q_start=16, score_dtype="float16")


@pytest.mark.parametrize("q_start", [0, 2048])
def test_planned_costs_count_the_rectangle(q_start):
    """On ``meta`` both kernels count the causal pairs of the rectangle,
    S (q_start + (S + 1) / 2) a head, and the bytes of q at S rows and k
    and v at q_start + S."""
    B, S, H, KH, D = 1, 2048, 32, 8, 64
    q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, q_start + S, KH, D, dtype=torch.bfloat16,
                    device="meta")
    K.meta_cost.clear()
    out, lse = K.flash_attention_fwd(q, k, k, keep_lse=True,
                                     q_start=q_start,
                                     score_dtype="bfloat16")
    assert out.shape == q.shape and lse.shape == (B, H, S)
    K.flash_attention_bwd(q, k, k, out, out, lse, q_start=q_start)
    pairs = S * (q_start + (S + 1) / 2)
    fwd, bwd = (K.meta_cost[n] for n in ("flash_attention",
                                         "flash_attention_bwd"))
    assert fwd["flops"] == 2.0 * B * H * 2 * D * pairs
    assert fwd["bytes"] == 2 * B * (S * H + (q_start + S) * KH) * 2 * D + (
        4 * B * H * S)
    assert bwd["flops"] == 10.0 * B * H * D * S * (q_start + S / 2)
    assert math.isclose(fwd["transcendentals"], B * H * pairs)


# ------------------------------------------------------- whole models
ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"]
B, P, STEPS, L = 2, 32, 4, 64
OPT = dict(lr=1e-3, warmup_steps=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = replace(get_smoke(arch), score_dtype="bfloat16")
    jcfg = replace(jax_get_smoke(arch), score_dtype="bfloat16")
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_jax(cfg, _np(jparams), "cpu")


def test_bf16_model_serves_as_jax(model):
    """Prefill of P tokens, then STEPS teacher-forced decode steps."""
    from repro.training import step as JSTEP
    cfg, jcfg, jparams, params = model
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, P + STEPS)).astype(np.int32)
    cache, _ = JT.init_cache(jcfg, B, P + STEPS)
    lg, cache = jax.jit(JSTEP.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :P])}, cache)
    want = [lg]
    step = jax.jit(JSTEP.make_decode_step(jcfg))
    for i in range(P, P + STEPS):
        lg, cache = step(jparams, jnp.asarray(tokens[:, i:i + 1]), cache,
                         jnp.int32(i))
        want.append(lg)
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        c = T.init_cache(cfg, B, P + STEPS, device="cpu")
        got, c = T.prefill(cfg, params, t[:, :P], c)
        outs = [got]
        for i in range(P, P + STEPS):
            got, c = T.decode_step(cfg, params, t[:, i:i + 1], c, i)
            outs.append(got)
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **BF16)


def test_bf16_model_trains_as_jax(model):
    """The loss and every gradient (each leaf within 2e-2 of its largest
    |g|), then one AdamW step: the loss and grad norm at 2e-2, and each
    weight's change against the JAX package's change.  Where the JAX
    gradient is beyond the gradients' 2e-2 (so both have its sign) or
    both are zero, AdamW's first step moves the weight by lr (sign(g) +
    wd w) in both: the changes agree within 2e-2 of the leaf's largest
    |change|, so a weight the step left alone fails.  Elsewhere the sign
    of the gradient may flip with bfloat16 scores: within 2 lr."""
    cfg, jcfg, jparams, params = model
    batch = {"tokens": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jm), jgrads = jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    params.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (total, m), grads = S.make_grad_fn(cfg)(params, tb)
    np.testing.assert_allclose(float(total), float(jtotal), **BF16)
    want = named_from_jax(cfg, _np(jgrads), device="cpu")
    assert grads.keys() == want.keys()
    for n, w in want.items():
        top = float(w.abs().max())
        assert float((grads[n] - w).abs().max()) <= 2e-2 * top, n
    jopt = JA.OptConfig(**OPT)
    jstate, jsm = jax.jit(JS.make_train_step(jcfg, jopt))(
        JA.init_state(jparams, jopt), jb)
    from repro_torch.optim.adamw import init_state
    opt = OptConfig(**OPT)
    old = {n: p.detach().clone() for n, p in params.named_parameters()}
    state, sm = S.make_train_step(cfg, opt)(init_state(params, opt), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(sm[k]), float(jsm[k]), **BF16)
    new = named_from_jax(cfg, _np(jstate.params), device="cpu")
    jold = named_from_jax(cfg, _np(jparams), device="cpu")
    sure_total = 0
    for n, p in state.params.named_parameters():
        got, jd = p.detach() - old[n], new[n] - jold[n]
        top = float(jd.abs().max())
        assert top > 0, n
        g, w = grads[n], want[n]
        sure = (w.abs() > 2e-2 * float(w.abs().max())) | (
            (w == 0) & (g == 0))
        sure_total += int(sure.sum())
        err = (got - jd).abs()
        assert float(torch.where(sure, err, 0.0).max()) <= 2e-2 * top, n
        assert float(err.max()) <= 2 * opt.lr + 1e-5, n
    assert sure_total > 0
