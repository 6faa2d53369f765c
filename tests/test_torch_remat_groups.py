"""The training forward's two-level remat in the port, against the JAX
package's grouping, on the CPU in float32.

- ``_auto_groups(n)`` is the JAX package's for n = 1 ... 130;
- the forward keeps at its top level (outside every checkpoint, seen
  through ``torch.autograd.graph.saved_tensors_hooks``) the G groups'
  inputs and the pre-blocks' where the flat remat keeps every layer's:
  a period-1 config (the smoke llama at 4 and 9 layers, G auto), jamba's
  period of 4 (8 layers, ``remat_groups`` 2) and deepseek's
  ``first_dense`` (5 layers, G auto), G the one the JAX package's
  ``forward`` takes;
- each layer's forward runs as often as ``forward_runs`` says (counted
  at the mixer);
- the loss and every gradient are bitwise equal with ``remat_groups`` 0
  (auto), 1 (flat) and n_blocks, for ``remat_inner`` "full" and "none",
  and equal those of ``jax.value_and_grad`` of the JAX loss at the same
  settings (loss rtol 1e-5, each gradient within 1e-4 of its largest
  |g|, the tolerances of ``tests/test_torch_train_families.py``).
Inputs are made with numpy from a seed."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.training import step as JS
from repro_torch.configs import get_smoke
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import named_from_jax, params_from_jax
from repro_torch.training import step as S

B, SEQ = 2, 16
# (arch, layers, remat_groups): a period-1 stack at two depths, jamba's
# period (two blocks, which the auto rule would not split) and deepseek's
# leading dense layer
CASES = [("llama3.2-1b", 4, 0), ("llama3.2-1b", 9, 0),
         ("jamba-v0.1-52b", 8, 2), ("deepseek-v2-lite-16b", 5, 0)]
IDS = [f"{a}-{n}" for a, n, _ in CASES]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, n_layers, groups, **kw):
    """(the port's config, the JAX package's) of the smoke ``arch`` at
    ``n_layers`` and ``remat_groups``; MoE capacity 1 keeps the routing's
    drops in play."""
    out = []
    for get in (get_smoke, jax_get_smoke):
        cfg = replace(get(arch), n_layers=n_layers, remat_groups=groups,
                      **kw)
        out.append(replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0)))
    return tuple(out)


def _n_blocks(cfg):
    return (cfg.n_layers - cfg.moe.first_dense) // cfg.block_period


def _jax_groups(jcfg):
    """The number of groups the JAX package's ``forward`` checkpoints, 1
    when it runs the blocks in one flat scan."""
    n = _n_blocks(jcfg)
    G = jcfg.remat_groups or JT._auto_groups(n)
    return G if G > 1 and n % G == 0 else 1


def _tokens(cfg, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32)


def test_auto_groups_equal_jax():
    got = [T._auto_groups(n) for n in range(1, 131)]
    assert got == [JT._auto_groups(n) for n in range(1, 131)]
    assert got[:16] == [1, 1, 1, 2, 1, 2, 1, 2, 3, 2, 1, 3, 1, 2, 3, 4]


@pytest.mark.parametrize("arch,n_layers,groups", CASES, ids=IDS)
def test_segments_follow_the_jax_grouping(arch, n_layers, groups):
    cfg, jcfg = _cfgs(arch, n_layers, groups)
    pre, groups = T.remat_segments(cfg)
    G = _jax_groups(jcfg)
    assert G > 1
    first = cfg.moe.first_dense
    assert pre == list(range(first)) and len(groups) == G
    assert sum(groups, []) == list(range(first, cfg.n_layers))
    assert {len(g) for g in groups} == {_n_blocks(cfg) // G
                                        * cfg.block_period}
    flat, none = (T.remat_segments(replace(cfg, remat_groups=1)),
                  T.remat_segments(replace(cfg, remat_groups=n_layers + 1)))
    assert flat == none == (list(range(n_layers)), [])


def _saved_and_runs(cfg, params, toks):
    """(the (B, S, d) tensors the forward saves outside every
    checkpoint, the mixer calls of the forward and of its backward)."""
    saved, calls = [], [0]
    mixers = {n: getattr(L, n) for n in ("gqa_apply", "mla_apply",
                                         "mamba_apply")}

    def counted(fn):
        def run(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return run

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    for n, fn in mixers.items():
        setattr(L, n, counted(fn))
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits, aux = T.forward(cfg, params, torch.from_numpy(toks))
        fwd = calls[0]
        torch.autograd.grad(logits.square().mean() + aux,
                            list(params.parameters()))
    finally:
        for n, fn in mixers.items():
            setattr(L, n, fn)
    return sum(s == (B, SEQ, cfg.d_model) for s in saved), fwd, calls[0]


@pytest.mark.parametrize("arch,n_layers,groups", CASES, ids=IDS)
def test_forward_keeps_the_group_inputs(arch, n_layers, groups):
    """The flat remat keeps every layer's input, the grouped one the
    groups' and the pre-blocks'; what the forward keeps beside the
    layers (embedding, final norm, head) is the same in both."""
    cfg, jcfg = _cfgs(arch, n_layers, groups)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    toks = _tokens(cfg)
    flat, fwd_flat, all_flat = _saved_and_runs(
        replace(cfg, remat_groups=1), params, toks)
    outside = flat - n_layers
    assert outside >= 0
    G = _jax_groups(jcfg)
    for inner in ("full", "none"):
        c = replace(cfg, remat_inner=inner)
        kept, fwd, total = _saved_and_runs(c, params, toks)
        assert kept == G + cfg.moe.first_dense + outside, inner
        assert fwd == fwd_flat == n_layers
        assert total == sum(T.forward_runs(c)), inner
    assert all_flat == sum(T.forward_runs(replace(cfg, remat_groups=1)))
    assert all_flat == 2 * n_layers


def _grads(cfg, params, toks):
    total, grads = S.make_grad_fn(cfg)(params,
                                       {"tokens": torch.from_numpy(toks)})
    return total, grads


@pytest.mark.parametrize("inner", ["full", "none"])
@pytest.mark.parametrize("arch,n_layers,groups", CASES, ids=IDS)
def test_gradients_equal_across_groupings_and_jax(arch, n_layers, groups,
                                                  inner):
    cfg, jcfg = _cfgs(arch, n_layers, groups, remat_inner=inner)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    params.requires_grad_(True)
    toks = _tokens(cfg, 7)
    out = {G: _grads(replace(cfg, remat_groups=G), params, toks)
           for G in (0, 1, _n_blocks(cfg))}
    (base, _), ref = out[1]
    for G, ((total, m), grads) in out.items():
        assert torch.equal(total, base), G
        for n, g in grads.items():
            assert torch.equal(g, ref[n]), (G, n)
    for G in out:
        jc = replace(jcfg, remat_groups=G)
        (jtotal, _), jgrads = jax.value_and_grad(
            JS.make_loss_fn(jc), has_aux=True)(
            jparams, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(float(base), float(jtotal), rtol=1e-5)
        want = named_from_jax(cfg, jax.tree.map(np.asarray, jgrads),
                              device="cpu")
        assert want.keys() == ref.keys()
        for n, w in want.items():
            top = float(w.abs().max())
            assert float((ref[n] - w).abs().max()) <= 1e-4 * top, (G, n)
