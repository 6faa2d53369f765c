"""The port's two modality frontends against the JAX package's, on the
CPU, in float32 with the JAX weights of ``init_params(PRNGKey(0))``
carried over by ``params_from_jax``: internvl2-1b's ``vit_stub``
(precomputed patch embeddings in place of the first positions' token
embeddings, a head tied to the embedding) and musicgen-large's
``encodec_stub`` (4 codebooks at full size, 2 in the smoke config: their
embeddings summed, every codebook predicted at each position).  The
scoring forward, prefill and teacher-forced decode, greedy decoding
(argmax per codebook for musicgen), the converted arrays, the
parameter counts and the servers' refusal of musicgen's codebooks.
Inputs are made with numpy from a seed.  Tolerance: rtol/atol 2e-4,
that of ``tests/test_torch_moe.py``."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
VLM, AUDIO = "internvl2-1b", "musicgen-large"
B, S, P = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(arch, seed=0, **cut):
    cfg = replace(get_smoke(arch), **cut)
    jcfg = replace(jax_get_smoke(arch), **cut)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, jcfg, jparams, params


def _tokens(cfg, shape, seed):
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape + cb).astype(np.int32)


@pytest.fixture(scope="module")
def vlm():
    cfg, jcfg, jparams, params = _model(VLM)
    toks = _tokens(cfg, (B, S), 1)
    patches = np.random.default_rng(2).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jparams, params, toks, patches


@pytest.fixture(scope="module")
def audio():
    cfg, jcfg, jparams, params = _model(AUDIO)
    return cfg, jcfg, jparams, params, _tokens(cfg, (B, S), 3)


def _prefill_decode(cfg, jcfg, jparams, params, toks, patches=None):
    """Prefill P positions, then 4 teacher-forced decode steps, in both
    packages; every step's logits must agree."""
    jcache, _ = JT.init_cache(jcfg, B, S)
    jp = None if patches is None else jnp.asarray(patches)
    tp = None if patches is None else torch.from_numpy(patches)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), jcache,
                             patches=jp)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :P]), cache,
                          patches=tp)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for i in range(P, P + 4):
        jlg, jcache = JT.decode_step(jcfg, jparams,
                                     jnp.asarray(toks[:, i:i + 1]), jcache,
                                     jnp.int32(i))
        lg, cache = T.decode_step(cfg, params,
                                  torch.from_numpy(toks[:, i:i + 1]), cache,
                                  i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    return lg


# ------------------------------------------------ internvl2-1b (vit_stub)
@pytest.mark.parametrize("with_patches", [True, False])
def test_vlm_forward_matches_jax(vlm, with_patches):
    cfg, jcfg, jparams, params, toks, patches = vlm
    pt = patches if with_patches else None
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks),
                         patches=None if pt is None else jnp.asarray(pt),
                         remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks),
                         patches=None if pt is None else torch.from_numpy(pt))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_prefill_with_patches_then_decode_matches_jax(vlm):
    cfg, jcfg, jparams, params, toks, patches = vlm
    lg = _prefill_decode(cfg, jcfg, jparams, params, toks, patches)
    assert lg.shape == (B, 1, cfg.vocab_size)


def test_vlm_patches_take_the_first_positions(vlm):
    """With patches, the tokens at the first n positions are not read:
    changing them leaves every logit as it was."""
    cfg, _, _, params, toks, patches = vlm
    n = cfg.n_patches
    other = toks.copy()
    other[:, :n] = (other[:, :n] + 1) % cfg.vocab_size
    pt = torch.from_numpy(patches)
    a, _ = T.forward(cfg, params, torch.from_numpy(toks), patches=pt)
    b, _ = T.forward(cfg, params, torch.from_numpy(other), patches=pt)
    assert torch.equal(a, b)
    c, _ = T.forward(cfg, params, torch.from_numpy(other))
    assert not torch.allclose(a, c)


def test_vlm_head_is_tied_to_the_embedding(vlm):
    cfg, jcfg, jparams, params, _, _ = vlm
    assert cfg.tie_embeddings and params.lm_head is None
    assert "lm_head" not in jparams
    x = np.random.default_rng(5).standard_normal(
        (B, 3, cfg.d_model)).astype(np.float32)
    got = T.lm_head(cfg, params, torch.from_numpy(x))
    torch.testing.assert_close(got, torch.from_numpy(x) @ params.embed.T)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JT.lm_head(jcfg, jparams, jnp.asarray(x))),
        **TOL)


# --------------------------------------------- musicgen-large (encodec_stub)
def test_audio_forward_logits_match_jax(audio):
    cfg, jcfg, jparams, params, toks = audio
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.n_codebooks, cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_audio_prefill_and_decode_match_jax(audio):
    cfg, jcfg, jparams, params, toks = audio
    lg = _prefill_decode(cfg, jcfg, jparams, params, toks)
    assert lg.shape == (B, 1, cfg.n_codebooks, cfg.vocab_size)


def test_audio_embedding_comes_across_with_its_codebooks(audio):
    cfg, _, jparams, params, _ = audio
    CB, V, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    assert params.embed.shape == (CB, V, d)
    assert params.lm_head.shape == (d, V * CB)
    np.testing.assert_array_equal(params.embed.numpy(),
                                  np.asarray(jparams["embed"]))
    np.testing.assert_array_equal(params.lm_head.numpy(),
                                  np.asarray(jparams["lm_head"]))
    # the codebooks' embeddings are summed position by position
    toks = _tokens(cfg, (1, 3), 6)
    x = T.embed_tokens(cfg, params, torch.from_numpy(toks))
    want = sum(params.embed[c][torch.from_numpy(toks[..., c]).long()]
               for c in range(CB))
    torch.testing.assert_close(x, want)


def test_audio_tied_head_flattens_the_codebooks():
    cfg, jcfg, jparams, params = _model(AUDIO, seed=7, tie_embeddings=True)
    assert params.lm_head is None
    x = np.random.default_rng(8).standard_normal(
        (B, 3, cfg.d_model)).astype(np.float32)
    got = T.lm_head(cfg, params, torch.from_numpy(x))
    assert got.shape == (B, 3, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JT.lm_head(jcfg, jparams, jnp.asarray(x))),
        **TOL)


GEN = 6
# a top-2 gap ten times the logits' tolerance cannot flip a greedy choice
MIN_GAP = 2e-3


def test_audio_greedy_codebooks_match_jax(audio):
    """Greedy decoding takes the argmax of each codebook: (B,1,CB) tokens
    a step, fed back as the next step's input, in both packages."""
    cfg, jcfg, jparams, params, toks = audio
    n = P
    cache = T.init_cache(cfg, B, n + GEN, device="cpu")
    jcache, _ = JT.init_cache(jcfg, B, n + GEN)
    with torch.inference_mode():
        lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :n]),
                              cache)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :n]), jcache)
    got, want = [], []
    for i in range(GEN):
        top2 = lg[:, -1].topk(2, dim=-1).values          # (B, CB, 2)
        assert float((top2[..., 0] - top2[..., 1]).min()) > MIN_GAP, i
        tok = lg[:, -1].argmax(-1)[:, None]              # (B, 1, CB)
        jtok = jnp.argmax(jlg[:, -1], -1)[:, None]
        assert tok.shape == (B, 1, cfg.n_codebooks)
        got.append(tok.numpy())
        want.append(np.asarray(jtok))
        with torch.inference_mode():
            lg, cache = T.decode_step(cfg, params, tok, cache, n + i)
        jlg, jcache = JT.decode_step(jcfg, jparams, jtok, jcache,
                                     jnp.int32(n + i))
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


# ------------------------------------------------------------ both
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_active_count_drops_the_embedding(arch, full):
    """``param_count``'s "active" drops the embedding's elements: CB*V*d
    for musicgen's codebooks, V*d for internvl2-1b (whose head is tied).
    Its equality with the JAX package's count is held for every config
    in ``tests/test_torch_train.py``."""
    cfg = get_config(arch) if full else get_smoke(arch)
    total, active = T.param_count(cfg)
    emb = cfg.vocab_size * cfg.d_model * (
        cfg.n_codebooks if cfg.frontend == "encodec_stub" else 1)
    assert total - active == emb
    if full:
        assert total == {VLM: 493_753_344, AUDIO: 3_254_978_560}[arch]


def test_audio_is_not_served_by_replicas(audio, monkeypatch):
    """Replicas serve (B, P) prompts of one token a position, as the JAX
    package's do; musicgen's positions hold CB codebooks, so ``Replica``
    and ``launch.serve`` refuse it with ``ValueError``, the latter before
    it builds any weight."""
    from repro_torch.launch import serve
    from repro_torch.serve import Replica
    cfg, _, _, params, _ = audio
    with pytest.raises(ValueError, match="codebooks"):
        Replica("r0", cfg, params, device="cpu")

    def no_weights(*a, **k):
        raise AssertionError("weights built before the refusal")

    monkeypatch.setattr(serve.T, "init_params", no_weights)
    with pytest.raises(ValueError, match="codebooks"):
        serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])
