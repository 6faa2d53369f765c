"""The port's hybrid attention/Mamba period with MoE (jamba-v0.1-52b)
against the JAX package's, on the CPU, in float32 with the JAX weights of
``init_params(PRNGKey(0))`` carried over by ``params_from_jax``: the
layer kinds and the JAX package's block indexing, the scoring forward
with its aux loss (also at the published capacity factor, where tokens
drop, and without MoE), prefill and teacher-forced decode, greedy tokens
through a replica, the parameter counts, the converted arrays and the
serving CLI.  The smoke config is one period of 4 layers at width 64:
Mamba + MoE, Mamba + MLP, attention + MoE, Mamba + MLP.  Inputs are made
with numpy from a seed.  Tolerance: rtol/atol 2e-4, that of
``tests/test_torch_moe.py``."""
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
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "jamba-v0.1-52b"
B, S, P = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _kinds(lp):
    """(mixer kind, MLP kind or None) of a port layer."""
    mix = "mamba" if isinstance(lp.mixer, L.Mamba) else "attn"
    mlp = (None if lp.mlp is None
           else "moe" if isinstance(lp.mlp, L.MoE) else "dense")
    return mix, mlp


def _jax_kinds(lp):
    """The same of a JAX layer's arrays."""
    mix = "mamba" if "in_proj" in lp["mixer"] else "attn"
    if "mlp" not in lp:
        return mix, None
    return mix, "moe" if "router" in lp["mlp"] else "dense"


@pytest.fixture(scope="module")
def smoke():
    cfg, jcfg = get_smoke(ARCH), jax_get_smoke(ARCH)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, _np(jparams), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, toks


@pytest.mark.parametrize("full", [False, True])
def test_layer_kinds_follow_the_config_and_the_jax_indexing(full):
    """Layer i has ``mixer_kind(i)``'s mixer, an MoE where ``mlp_kind(i)``
    says so and a dense MLP (with ``ln2``) elsewhere, Mamba layers
    included; and the JAX package's index of sub-layer i of every block,
    ``first_dense + i``, gives the same kinds as the port's plain index,
    because the kinds repeat with the period."""
    cfg = get_config(ARCH) if full else get_smoke(ARCH)
    params = T.init_abstract(cfg)
    Pd, fd = cfg.block_period, cfg.moe.first_dense
    assert Pd == (8 if full else 4) and len(params.layers) == cfg.n_layers
    for i, lp in enumerate(params.layers):
        want = (cfg.mixer_kind(i), cfg.mlp_kind(i))
        assert _kinds(lp) == want, i
        assert lp.ln2 is not None
        if i >= fd:
            rep = fd + (i - fd) % Pd
            assert (cfg.mixer_kind(rep), cfg.mlp_kind(rep)) == want, i
    kinds = [_kinds(lp) for lp in params.layers]
    assert kinds.count(("attn", "moe")) == cfg.n_layers // Pd
    n_mamba = sum(m == "mamba" for m, _ in kinds)
    assert n_mamba == cfg.n_layers * (Pd - 1) // Pd


def test_converted_layers_keep_the_jax_arrays(smoke):
    """Each JAX sub-layer becomes the port layer of its own kinds, with its
    arrays as they were (a Mamba layer's ``ln2`` and MLP included)."""
    cfg, _, jparams, params, _ = smoke
    blocks = _np(jparams["blocks"])
    for b in range(cfg.n_layers // cfg.block_period):
        for i in range(cfg.block_period):
            jl = jax.tree.map(lambda a: a[b], blocks[f"sub{i}"])
            lp = params.layers[b * cfg.block_period + i]
            assert _kinds(lp) == _jax_kinds(jl)
            np.testing.assert_array_equal(lp.ln2.numpy(), jl["ln2"])
            mlp = jl["mlp"]
            np.testing.assert_array_equal(lp.mlp.w_down.numpy(),
                                          mlp["w_down"])
            if isinstance(lp.mixer, L.Mamba):
                for n in L.Mamba.NAMES:
                    np.testing.assert_array_equal(
                        getattr(lp.mixer, n).numpy(), jl["mixer"][n])


def test_cache_follows_each_layers_mixer():
    cfg = get_smoke(ARCH)
    cache = T.init_cache(cfg, B, S, device="cpu")
    for i, c in enumerate(cache):
        if cfg.mixer_kind(i) == "attn":
            assert set(c) == {"k", "v"} and c["k"].shape[1] == S
        else:
            assert set(c) == {"h", "conv"}
            assert c["h"].shape == (B, cfg.d_inner, cfg.ssm.d_state)


def test_forward_logits_and_aux_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    want, want_aux = JT.forward(jcfg, jparams, jnp.asarray(toks),
                                remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("cut", ["capacity 1.25", "no MoE"])
def test_forward_of_cut_configs_matches_jax(cut, monkeypatch):
    """The period at the published capacity factor (1.25: tokens drop at
    this width) and the hybrid period without MoE layers."""
    def cfg_of(c):
        if cut == "no MoE":
            return replace(c, moe=replace(c.moe, n_routed=0))
        return replace(c, moe=replace(c.moe, capacity_factor=1.25))
    cfg, jcfg = cfg_of(get_smoke(ARCH)), cfg_of(jax_get_smoke(ARCH))
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(cfg, _np(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, want_aux = JT.forward(jcfg, jparams, jnp.asarray(toks),
                                remat=False)
    choices = []
    route = L.moe_route

    def recorded(*a):
        out = route(*a)
        choices.append(out[2].numpy())
        return out
    monkeypatch.setattr(L, "moe_route", recorded)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if cut == "no MoE":
        assert not choices
    else:
        E, k = cfg.moe.n_routed, cfg.moe.top_k
        C = int(np.ceil(cfg.moe.capacity_factor * k * S / E))
        assert len(choices) == 2 and sum(
            int(np.maximum(np.bincount(row.reshape(-1), minlength=E) - C,
                           0).sum())
            for idx in choices for row in idx) > 0
    assert [_kinds(lp) for lp in params.layers] == [
        (cfg.mixer_kind(i), cfg.mlp_kind(i)) for i in range(cfg.n_layers)]


def test_prefill_and_decode_logits_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    jcache, _ = JT.init_cache(jcfg, B, S)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :P]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for i in range(P, P + 4):
        jlg, jcache = JT.decode_step(jcfg, jparams,
                                     jnp.asarray(toks[:, i:i + 1]), jcache,
                                     jnp.int32(i))
        lg, cache = T.decode_step(cfg, params,
                                  torch.from_numpy(toks[:, i:i + 1]), cache,
                                  i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


def test_prefill_decode_match_own_forward(smoke):
    cfg, _, _, params, toks = smoke
    t = torch.from_numpy(toks)
    full, _ = T.forward(cfg, params, t)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, t[:, :P], cache)
    torch.testing.assert_close(lg[:, 0], full[:, P - 1], **TOL)
    for i in range(P, S):
        lg, cache = T.decode_step(cfg, params, t[:, i:i + 1], cache, i)
        torch.testing.assert_close(lg[:, 0], full[:, i], rtol=5e-4,
                                   atol=5e-4)


GEN = 6
# a top-2 gap ten times the logits' tolerance cannot flip a greedy choice
MIN_GAP = 2e-3


def test_greedy_tokens_match_jax_replica(smoke):
    cfg, jcfg, jparams, params, _ = smoke
    prompts = np.random.default_rng(24).integers(
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
    want = JS.Replica("jax", jcfg, jparams).serve(prompts, GEN)
    assert got.shape == (2, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


# totals at full width, cut to whole periods of 8 layers
WHOLE_PERIODS = {1: 13_295_235_072, 2: 26_053_595_136, 4: 51_570_315_264}


@pytest.mark.parametrize("periods", sorted(WHOLE_PERIODS))
def test_param_count_of_whole_periods(periods):
    """Two periods (16 layers, 52.1 GB in bfloat16) are what
    ``chip_smoke.py`` serves on one 80 GB card; all four (103.1 GB) do
    not fit.  The cuts count as the JAX package counts them (the whole
    model is held in ``tests/test_torch_train.py``)."""
    n = 8 * periods
    cfg = replace(get_config(ARCH), n_layers=n)
    total = T.param_count(cfg)[0]
    assert total == WHOLE_PERIODS[periods]
    if n < get_config(ARCH).n_layers:
        assert T.param_count(cfg) == JT.param_count(
            replace(jax_get_config(ARCH), n_layers=n))
    assert (2 * total < 80e9) == (periods <= 2)


def test_launch_serve_jamba_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--check-invariance", "--requests", "8",
                     "--replicas", "r0:1,r1:2"])
    out = capsys.readouterr().out
    assert rc == 0 and "outputs replica-invariant: True" in out
