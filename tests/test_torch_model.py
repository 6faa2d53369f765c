"""The port's dense GQA model (``repro_torch.models``) against the JAX
package's, on the CPU: the smoke ``llama3.2-1b`` in float32 with the JAX
weights of ``init_params(PRNGKey(0))`` carried over by
``params_from_jax``.  Logits of the scoring forward, of prefill and of
teacher-forced decode steps agree at rtol/atol 2e-4, the tolerance of
``tests/test_decode.py:30``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, P = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs, so it does not starve the others'
    timing-sensitive threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke("llama3.2-1b")
    jcfg = jax_get_smoke("llama3.2-1b")
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, toks


def test_configs_match_the_jax_package():
    from repro.configs import ARCH_IDS as JIDS, get_config as jget
    assert ARCH_IDS == JIDS
    for arch in ARCH_IDS:
        assert repr(get_config(arch)) == repr(jget(arch))
        assert repr(get_smoke(arch)) == repr(jax_get_smoke(arch))


def test_forward_logits_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    got, aux = T.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_jax(smoke):
    cfg, jcfg, jparams, params, toks = smoke
    jcache, _ = JT.init_cache(jcfg, B, S)
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = T.init_cache(cfg, B, S, device="cpu")
    lg, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :P]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for i in range(P, P + 3):
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


def test_own_init_is_seeded_and_shaped():
    cfg = get_smoke("llama3.2-1b")
    a = T.init_params(cfg, torch.Generator().manual_seed(0))
    b = T.init_params(cfg, torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad
    hd = cfg.resolved_head_dim
    assert a.layers[0].mixer.wq.shape == (cfg.d_model, cfg.n_heads * hd)
    assert a.layers[0].mixer.wo.shape == (cfg.n_heads * hd, cfg.d_model)
    assert a.lm_head is None and len(a.layers) == cfg.n_layers


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "internvl2-1b",
                                  "musicgen-large"])
def test_other_families_are_later_slices(arch):
    """The families this test once found refused (the hybrid period with
    MoE, the vit_stub and encodec_stub frontends) are ported: the port
    accepts them and its weights have the JAX package's count
    (``tests/test_torch_hybrid.py`` and ``tests/test_torch_frontend.py``
    hold their values)."""
    cfg = get_smoke(arch)
    T.check_supported(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in params.parameters())
    assert n == JT.param_count(jax_get_smoke(arch))[0]
