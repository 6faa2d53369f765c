"""The port's MoE layer and MoE models against the JAX package's, on the
CPU, in float32 with the JAX weights carried over by ``params_from_jax``:
the layer (``moe_apply``) under both dispatches, with and without shared
experts, at the smoke capacity factor (no drops) and at the published
1.25 (drops), the auxiliary loss included; the deepseek-v2-lite-16b
(MLA + MoE) and dbrx-132b (GQA + MoE) smoke models' forward, prefill,
teacher-forced decode, greedy tokens through a replica and parameter
counts; what ``check_supported`` refuses, and the plain scan's gradient.
(MoE and MLA training: ``tests/test_torch_train_families.py``.)  Tolerance: rtol/atol 2e-4, that of
``tests/test_torch_model.py``."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import repro.serve as JS
import repro_torch.serve as TS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.mamba_scan import kernel as KS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b"]
B, S, P = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return nn.Parameter(torch.from_numpy(np.array(a)), requires_grad=False)


def _moe_cfgs(dispatch, n_shared, capacity_factor):
    """The smoke deepseek's MoE at 8 experts, top-2, in both packages."""
    def cut(c):
        return replace(c, moe=replace(
            c.moe, n_routed=8, top_k=2, d_ff=32, n_shared=n_shared,
            dispatch=dispatch, capacity_factor=capacity_factor))
    return cut(get_smoke(ARCHS[0])), cut(jax_get_smoke(ARCHS[0]))


def _dropped(gate_idx, E, C):
    """Choices past their expert's capacity, counted per group (each row
    of ``gate_idx``: (groups, choices))."""
    n = 0
    for row in gate_idx:
        counts = np.bincount(row.reshape(-1), minlength=E)
        n += int(np.maximum(counts - C, 0).sum())
    return n


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_layer_matches_jax(dispatch, n_shared, capacity_factor):
    cfg, jcfg = _moe_cfgs(dispatch, n_shared, capacity_factor)
    jp, _ = JL.moe_init(jcfg, jax.random.PRNGKey(5), jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    shared = (L.MLP(*(_t(jp["shared"][n])
                      for n in ("w_gate", "w_up", "w_down")))
              if n_shared else None)
    p = L.MoE(*(_t(jp[n]) for n in L.MoE.NAMES), shared)
    rng = np.random.default_rng(6)
    d = cfg.d_model
    # a direction that every token shares skews the routing, so that the
    # published capacity factor drops tokens
    x = (rng.standard_normal((B, S, d))
         + 2.0 * rng.standard_normal(d)).astype(np.float32)
    want, want_aux = JL.moe_apply(jcfg, jp, jnp.asarray(x))
    got, aux = L.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert aux.dtype == torch.float32
    # drops: counted from the router's choices, per row (grouped) or over
    # the whole batch (global)
    _, _, gate_idx = L.moe_route(cfg, p, torch.from_numpy(x))
    E, k = cfg.moe.n_routed, cfg.moe.top_k
    idx = gate_idx.numpy()
    if dispatch == "global":
        idx = idx.reshape(1, -1)
    tokens = S if dispatch == "grouped" else B * S
    C = int(np.ceil(capacity_factor * k * tokens / E))
    n_drop = _dropped(idx.reshape(idx.shape[0], -1), E, C)
    if capacity_factor == 4.0:
        assert n_drop == 0
    else:
        assert n_drop > 0


def test_grouped_dispatch_is_local_to_each_row():
    """Under ``grouped`` a batch row's output does not depend on the
    other rows: the capacity and the slots are counted within the row."""
    cfg, _ = _moe_cfgs("grouped", 1, 1.25)
    p = L.moe_init(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn(3, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)) + torch.randn(cfg.d_model)
    y, _ = L.moe_apply(cfg, p, x)
    for b in range(3):
        yb, _ = L.moe_apply(cfg, p, x[b:b + 1])
        torch.testing.assert_close(y[b:b + 1], yb, **TOL)


def test_router_keeps_float32_in_a_bfloat16_model():
    cfg = get_smoke(ARCHS[0])
    p = L.moe_init(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert p.router.dtype == torch.float32
    assert p.w_gate.dtype == torch.bfloat16
    E, d, f = cfg.moe.n_routed, cfg.d_model, cfg.moe_d_ff
    assert p.w_gate.shape == (E, d, f) and p.w_down.shape == (E, f, d)
    assert p.shared.w_gate.shape == (d, cfg.moe.n_shared * f)
    x = torch.randn(2, 5, d).to(torch.bfloat16)
    y, aux = L.moe_apply(cfg, p, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, toks


def test_layer_kinds_follow_the_config(smoke):
    cfg, _, jparams, params, _ = smoke
    for i, lp in enumerate(params.layers):
        assert isinstance(lp.mixer, L.MLA if cfg.attn_kind == "mla"
                          else L.GQA)
        assert isinstance(lp.mlp, L.MoE if cfg.mlp_kind(i) == "moe"
                          else L.MLP)
    assert len(jparams.get("pre_blocks", [])) == cfg.moe.first_dense


def test_forward_logits_and_aux_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    want, want_aux = JT.forward(jcfg, jparams, jnp.asarray(toks),
                                remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0


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


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch, full):
    cfg = get_config(arch) if full else get_smoke(arch)
    jcfg = jax_get_config(arch) if full else jax_get_smoke(arch)
    total, active = T.param_count(cfg)
    assert (total, active) == JT.param_count(jcfg)
    assert active < total
    if full and arch == ARCHS[0]:
        assert total == 15_706_484_224      # 31.4 GB in bfloat16


def test_launch_serve_deepseek_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCHS[0], "--smoke", "--device", "cpu",
                     "--check-invariance", "--requests", "8",
                     "--replicas", "r0:1,r1:2"])
    out = capsys.readouterr().out
    assert rc == 0 and "outputs replica-invariant: True" in out


# ------------------------------------------------- refusals and guards
# The case ids keep the names of the families these cases once found
# refused; ``refused`` is what ``check_supported`` names now (None: it
# accepts the config).
@pytest.mark.parametrize("arch,cut,refused", [
    pytest.param("jamba-v0.1-52b", {}, None,
                 id="jamba-v0.1-52b-cut0-recurrent family with MoE"),
    pytest.param("jamba-v0.1-52b", {"moe": None}, None,
                 id="jamba-v0.1-52b-cut1-hybrid"),
    pytest.param("internvl2-1b", {}, None, id="internvl2-1b-cut2-frontend"),
    pytest.param("llama3.2-1b", {"score_dtype": "bfloat16"}, "score_dtype",
                 id="llama3.2-1b-cut3-score_dtype"),
])
def test_check_supported_names_what_is_missing(arch, cut, refused):
    """What is missing is a score dtype other than float32 (the attention
    kernels keep their scores in float32): ``check_supported`` names it.
    A recurrent family with MoE, the hybrid period without MoE and a
    frontend are accepted, and their weights have the JAX package's
    count."""
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    if "moe" in cut:
        cfg, jcfg = (replace(c, moe=replace(c.moe, n_routed=0))
                     for c in (cfg, jcfg))
    if refused:
        with pytest.raises(NotImplementedError, match=refused):
            T.check_supported(replace(cfg, **cut))
        return
    T.check_supported(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in params.parameters()) == (
        JT.param_count(jcfg)[0])


def test_plain_scan_keeps_its_gradient():
    """The plain version, which CPU tensors take, carries the gradient
    to every input (on a card the backward kernel does:
    ``tests/test_torch_cuda.py``)."""
    g = torch.Generator().manual_seed(0)
    a = (0.5 + 0.4 * torch.rand(1, 6, 4, 3, generator=g)).requires_grad_()
    b = torch.randn(1, 6, 4, 3, generator=g, requires_grad=True)
    C = torch.randn(1, 6, 3, generator=g, requires_grad=True)
    h0 = torch.randn(1, 4, 3, generator=g, requires_grad=True)
    y, h = KS.selective_scan(a, b, C, h0)
    (y.sum() + h.sum()).backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (a, b, C, h0))
