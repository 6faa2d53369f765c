"""The port's dense GQA model at the three dense configs that
``tests/test_torch_model.py`` does not hold (qwen3-32b with its q/k
RMSNorm, yi-9b at G = 8 in its published widths, stablelm-3b, the one MHA
config, at head dim 80) against the JAX package's, on the CPU, in
float32.

Each config runs twice: at its smoke config, and at its real head dim
and group at smoke width (qwen3 D = 128, H = 16, KH = 2; yi D = 128, H =
8, KH = 1; stablelm D = 80, H = KH = 4), both packages' smoke configs cut
alike with ``dataclasses.replace``.  The JAX weights come from
``init_params(PRNGKey(0))``; every norm weight (``ln1``, ``ln2``,
``final_norm`` and qwen3's ``q_norm``/``k_norm``), which both packages
initialise to ones, is overwritten with seeded numpy values, so that a
dropped or swapped norm weight shows; ``params_from_jax`` carries them
over.  Logits of the scoring forward, of prefill and of three
teacher-forced decode steps agree at rtol/atol 2e-4, the tolerance of
``tests/test_torch_model.py``."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as JS
import repro_torch.serve as TS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, P = 2, 32, 16
DECODE_STEPS = 3
ARCHS = ["qwen3-32b", "yi-9b", "stablelm-3b"]
# each config's real head dim and group at smoke width
REAL_HEADS = {"qwen3-32b": dict(head_dim=128, n_heads=16, n_kv_heads=2),
              "yi-9b": dict(head_dim=128, n_heads=8, n_kv_heads=1),
              "stablelm-3b": dict(head_dim=80, n_heads=4, n_kv_heads=4)}
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
CASES = [(arch, heads) for arch in ARCHS for heads in ("smoke", "real")]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(arch, heads):
    """(the port's config, the JAX package's) of one case."""
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    if heads == "real":
        cfg, jcfg = (replace(c, **REAL_HEADS[arch]) for c in (cfg, jcfg))
    return cfg, jcfg


def _seeded_norms(tree, rng):
    """The JAX parameter tree with every norm weight drawn from ``rng``
    (uniform in [0.5, 1.5)), keys visited in sorted order."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                    if k in NORMS else _seeded_norms(v, rng))
                for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_seeded_norms(v, rng) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{h}" for a, h in CASES])
def case(request):
    arch, heads = request.param
    cfg, jcfg = _configs(arch, heads)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = _seeded_norms(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(3))
    params = params_from_jax(cfg, jparams, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, toks


def test_case_has_the_heads_it_names(case):
    cfg, jcfg, _, params, _ = case
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert (H, KH, hd) == (jcfg.n_heads, jcfg.n_kv_heads,
                           jcfg.resolved_head_dim)
    mixer = params.layers[0].mixer
    assert mixer.wq.shape == (cfg.d_model, H * hd)
    assert mixer.wk.shape == (cfg.d_model, KH * hd)
    assert (mixer.q_norm is None) == (not cfg.qk_norm)


def test_norm_weights_are_carried_over(case):
    """``params_from_jax`` carries every norm weight, qwen3's q/k norms
    included, and none of them is the ones both packages start from."""
    cfg, _, jparams, params, _ = case
    blocks = jparams["blocks"]["sub0"]
    pairs = [(params.final_norm, jparams["final_norm"])]
    for i, lp in enumerate(params.layers):
        pairs += [(lp.ln1, blocks["ln1"][i]), (lp.ln2, blocks["ln2"][i])]
        if cfg.qk_norm:
            mx = blocks["mixer"]
            pairs += [(lp.mixer.q_norm, mx["q_norm"][i]),
                      (lp.mixer.k_norm, mx["k_norm"][i])]
    assert len(pairs) == 1 + cfg.n_layers * (4 if cfg.qk_norm else 2)
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not np.allclose(np.asarray(want), 1.0)


def test_forward_logits_match_jax(case):
    cfg, jcfg, jparams, params, toks = case
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_jax(case):
    cfg, jcfg, jparams, params, toks = case
    jcache, _ = JT.init_cache(jcfg, B, S)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :P]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for i in range(P, P + DECODE_STEPS):
        jlg, jcache = JT.decode_step(jcfg, jparams,
                                     jnp.asarray(toks[:, i:i + 1]), jcache,
                                     jnp.int32(i))
        lg, cache = T.decode_step(cfg, params,
                                  torch.from_numpy(toks[:, i:i + 1]), cache,
                                  i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


@pytest.mark.parametrize("which", ["q_norm", "k_norm"])
@pytest.mark.parametrize("heads", ["smoke", "real"])
def test_qk_norm_weights_change_qwen3_logits(heads, which):
    """Scaling the port's ``q_norm`` (or ``k_norm``) by 2 scales every
    attention score by 2: qwen3's logits move beyond ``TOL``, so the
    parity tests above would see a dropped or swapped norm weight."""
    cfg, jcfg = _configs("qwen3-32b", heads)
    assert cfg.qk_norm
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = _seeded_norms(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(3))
    params = params_from_jax(cfg, jparams, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    base, _ = T.forward(cfg, params, toks)
    for lp in params.layers:
        getattr(lp.mixer, which).mul_(2.0)
    scaled, _ = T.forward(cfg, params, toks)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(scaled, base, **TOL)
    assert float((scaled - base).abs().max()) > 10 * TOL["atol"]


# a top-2 gap ten times the logits' tolerance cannot flip a greedy choice;
# the prompts (seed 5) keep every step's gap above it at all three configs
GEN = 6
MIN_GAP = 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_replica(arch):
    cfg, jcfg = _configs(arch, "smoke")
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = _seeded_norms(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(3))
    params = params_from_jax(cfg, jparams, device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got = TS.Replica("port", cfg, params, device="cpu").serve(prompts, GEN)
    with torch.inference_mode():
        n = prompts.shape[1]
        cache = T.init_cache(cfg, 2, n + GEN, device="cpu")
        lg, cache = T.prefill(cfg, params, torch.from_numpy(prompts), cache)
        for i in range(GEN):
            top2 = lg[:, -1].topk(2, dim=-1).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > MIN_GAP, i
            lg, cache = T.decode_step(cfg, params,
                                      torch.from_numpy(got[:, i:i + 1]),
                                      cache, n + i)
    want = JS.Replica("jax", jcfg, jax.tree.map(jnp.asarray, jparams)).serve(
        prompts, GEN)
    assert got.shape == (2, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


# the published sizes (``param_count`` on the meta device), and the four
# served configs' bfloat16 weights
PUBLISHED = {"qwen3-32b": 32_762_123_264, "yi-9b": 8_829_407_232,
             "stablelm-3b": 2_795_276_800, "dbrx-132b": 131_596_523_520}


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_param_count_matches_jax(arch):
    total, active = T.param_count(get_config(arch))
    assert (total, active) == JT.param_count(jax_get_config(arch))
    assert total == PUBLISHED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--check-invariance", "--requests", "8",
                     "--replicas", "r0:1,r1:2"])
    out = capsys.readouterr().out
    assert rc == 0 and "outputs replica-invariant: True" in out
