"""The port's MLA attention (``repro_torch.models.layers.mla_*``) against
the JAX package's on the CPU: the smoke deepseek-v2-lite-16b's widths in
float32, the JAX weights of ``mla_init`` carried over to the port's
matmul layout.  The expanded (train/prefill) path, the compressed caches
it writes, the absorbed decode path and the shared causal core at MLA's
head dim (nope + rope, v zero-padded to it) agree at rtol/atol 2e-4, the
tolerance of ``tests/test_torch_model.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke
from repro_torch.kernels.flash_attention import kernel as KA
from repro_torch.models import layers as L

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "deepseek-v2-lite-16b"
B, S = 2, 24


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


@pytest.fixture(scope="module")
def layer():
    cfg, jcfg = get_smoke(ARCH), jax_get_smoke(ARCH)
    jp, _ = JL.mla_init(jcfg, jax.random.PRNGKey(3), jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    d = cfg.d_model
    p = L.MLA(_t(jp["wq"].reshape(d, -1)), _t(jp["wkv_a"]),
              _t(jp["kv_norm"]),
              _t(jp["wkv_b"].reshape(jp["wkv_b"].shape[0], -1)),
              _t(jp["wo"].reshape(-1, d)))
    x = np.random.default_rng(4).standard_normal((B, S, d)).astype(
        np.float32)
    return cfg, jcfg, jp, p, x


def test_converted_layout_keeps_the_heads(layer):
    cfg, _, jp, p, _ = layer
    m, H = cfg.mla, cfg.n_heads
    assert p.wq.shape == (cfg.d_model, H * (m.nope_head_dim
                                            + m.rope_head_dim))
    np.testing.assert_array_equal(
        p.wkv_b.view(m.kv_lora_rank, H, -1).numpy(), jp["wkv_b"])
    np.testing.assert_array_equal(
        p.wo.view(H, m.v_head_dim, -1).numpy(), jp["wo"])


def test_own_init_is_seeded_and_shaped():
    cfg = get_smoke(ARCH)
    m = cfg.mla
    a = L.mla_init(cfg, torch.Generator().manual_seed(0), torch.float32)
    b = L.mla_init(cfg, torch.Generator().manual_seed(0), torch.float32)
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert len(list(a.parameters())) == 5
    assert a.wkv_a.shape == (cfg.d_model, m.kv_lora_rank + m.rope_head_dim)
    assert a.wkv_b.shape == (m.kv_lora_rank, cfg.n_heads
                             * (m.nope_head_dim + m.v_head_dim))
    assert a.wo.shape == (cfg.n_heads * m.v_head_dim, cfg.d_model)


@pytest.mark.parametrize("n", [1, 7, S])
def test_expanded_path_matches_jax(layer, n):
    cfg, jcfg, jp, p, x = layer
    want, _ = JL.mla_apply(jcfg, jp, jnp.asarray(x[:, :n]), jnp.arange(n))
    got, cache = L.mla_apply(cfg, p, torch.from_numpy(x[:, :n]),
                             torch.arange(n))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_writes_the_compressed_caches_like_jax(layer):
    cfg, jcfg, jp, p, x = layer
    P = 16
    jc, _ = JL.mla_cache_init(jcfg, B, S, jnp.float32)
    want, jc = JL.mla_apply(jcfg, jp, jnp.asarray(x[:, :P]), jnp.arange(P),
                            cache=jc)
    cache = L.mla_cache_init(cfg, B, S, torch.float32, "cpu")
    got, cache2 = L.mla_apply(cfg, p, torch.from_numpy(x[:, :P]),
                              torch.arange(P), cache=cache)
    assert cache2 is cache            # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("ckv", "krope"):
        assert cache[name].shape == jc[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
        assert not cache[name][:, P:].any()


def test_absorbed_decode_matches_jax(layer):
    """Prefill, then teacher-forced single-token steps through the
    absorbed path: outputs and both caches agree at every step."""
    cfg, jcfg, jp, p, x = layer
    P = 12
    jc, _ = JL.mla_cache_init(jcfg, B, S, jnp.float32)
    _, jc = JL.mla_apply(jcfg, jp, jnp.asarray(x[:, :P]), jnp.arange(P),
                         cache=jc)
    cache = L.mla_cache_init(cfg, B, S, torch.float32, "cpu")
    L.mla_apply(cfg, p, torch.from_numpy(x[:, :P]), torch.arange(P),
                cache=cache)
    for i in range(P, S):
        want, jc = JL.mla_apply(jcfg, jp, jnp.asarray(x[:, i:i + 1]),
                                jnp.full((1,), i), cache=jc, pos=jnp.int32(i))
        got, cache = L.mla_apply(cfg, p, torch.from_numpy(x[:, i:i + 1]),
                                 torch.full((1,), i), cache=cache, pos=i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_absorbed_decode_matches_own_expanded_path(layer):
    """The latent-space step at position i gives row i of the expanded
    causal path over the whole sequence."""
    cfg, _, _, p, x = layer
    full, _ = L.mla_apply(cfg, p, torch.from_numpy(x), torch.arange(S))
    cache = L.mla_cache_init(cfg, B, S, torch.float32, "cpu")
    L.mla_apply(cfg, p, torch.from_numpy(x[:, :1]), torch.arange(1),
                cache=cache)
    for i in range(1, S):
        got, cache = L.mla_apply(cfg, p, torch.from_numpy(x[:, i:i + 1]),
                                 torch.full((1,), i), cache=cache, pos=i)
        torch.testing.assert_close(got[:, 0], full[:, i], **TOL)


@pytest.mark.parametrize("S_,chunk", [(64, 64), (96, 32), (50, 64)])
def test_attention_core_at_head_dim_192_matches_jax(S_, chunk):
    """The causal core at MLA's D = 192 (H = KH, G = 1): the port's plain
    version (what ``flash_attention`` runs on CPU tensors) against the
    JAX package's blocked schedule, with v zero-padded from 128 as MLA
    pads it; the padded columns of the output stay zero."""
    rng = np.random.default_rng(S_)
    H = 4
    q, k = (rng.standard_normal((2, S_, H, 192)).astype(np.float32)
            for _ in range(2))
    v = np.zeros((2, S_, H, 192), np.float32)
    v[..., :128] = rng.standard_normal((2, S_, H, 128))
    want = JL.blocked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), chunk)
    got = KA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[..., 128:].any()


def test_plain_attention_at_head_dim_192_keeps_its_gradient():
    """On CPU tensors ``flash_attention`` is the plain version, which
    autograd differentiates at any head dim (only the CUDA kernel's
    backward stops at 128)."""
    q, k, v = (torch.randn(1, 9, 2, 192, requires_grad=True)
               for _ in range(3))
    KA.flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))


def test_cache_init_shapes():
    cfg = get_smoke(ARCH)
    c = L.mla_cache_init(cfg, 3, 40, torch.float32, "cpu")
    assert c["ckv"].shape == (3, 40, cfg.mla.kv_lora_rank)
    assert c["krope"].shape == (3, 40, cfg.mla.rope_head_dim)
    assert not c["ckv"].any() and not c["krope"].any()
