"""Training of the three dense configs that ``tests/test_torch_train.py``
and ``tests/test_torch_train_families.py`` leave out (qwen3-32b with its
q/k RMSNorm, yi-9b, stablelm-3b), on the CPU, in float32, against the
JAX package.

Each config runs twice, as ``tests/test_torch_dense_configs.py`` runs it:
at its smoke config, and at its real head dim and group at smoke width
(``REAL_HEADS``: qwen3 D = 128, 16/2; yi D = 128, 8/1; stablelm D = 80,
4/4).  The JAX weights come from ``init_params(PRNGKey(0))`` with every
norm weight (``ln1``, ``ln2``, ``final_norm``, qwen3's ``q_norm`` and
``k_norm``) overwritten with seeded numpy values, so that a dropped or
swapped norm gradient shows; ``params_from_jax`` carries them over.

- loss and every gradient against ``jax.value_and_grad`` of the JAX
  ``make_loss_fn`` (loss rtol 1e-5, each gradient within 1e-4 of its
  largest |g|, the tolerances of ``tests/test_torch_train_families.py``),
  qwen3's ``q_norm``/``k_norm`` gradients among them;
- ``make_train_step`` against the JAX step (updated parameters at
  ``STEP_TOL``, but for AdamW's sign flips: ``FLIPS``), at accum 1 for
  every case and at accum 2 for qwen3 at its real heads.
Inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import step as JS
from repro_torch.models.convert import (named_from_jax, params_from_jax,
                                        state_from_jax)
from repro_torch.optim.adamw import OptConfig
from repro_torch.training import step as S
from test_torch_dense_configs import ARCHS, _configs, _seeded_norms
from test_torch_train_families import _assert_updates_close

B, L = 4, 32
CASES = [(arch, heads) for arch in ARCHS for heads in ("smoke", "real")]
IDS = [f"{a}-{h}" for a, h in CASES]
OPT = dict(lr=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _case(arch, heads):
    """(the port's config, the JAX package's, the JAX weights with seeded
    norms as numpy, the numpy batch)."""
    cfg, jcfg = _configs(arch, heads)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = _seeded_norms(_np_tree(jparams), np.random.default_rng(3))
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)
    return cfg, jcfg, jparams, {"tokens": tokens}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return _case(*request.param)


def test_loss_and_gradients_match_jax(case):
    cfg, jcfg, jparams, batch = case
    (jtotal, jm), jgrads = jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(cfg, jparams, "cpu")
    params.requires_grad_(True)
    (total, m), grads = S.make_grad_fn(cfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["aux"]) == 0.0
    want = named_from_jax(cfg, _np_tree(jgrads), device="cpu")
    assert grads.keys() == want.keys()
    norms = [n for n in want if n.endswith(("q_norm", "k_norm"))]
    assert len(norms) == (2 * cfg.n_layers if cfg.qk_norm else 0)
    for n, w in want.items():
        top = float(w.abs().max())
        assert top > 0, n
        assert float((grads[n] - w).abs().max()) <= 1e-4 * top, n


def _step(case, accum):
    cfg, jcfg, jparams, batch = case
    opt, jopt = OptConfig(**OPT), JA.OptConfig(**OPT)
    jstate0 = JA.init_state(jax.tree.map(jnp.asarray, jparams), jopt)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, accum_steps=accum))
    jstate, jm = jstep(jstate0,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    state = state_from_jax(cfg, _np_tree(jstate0), "cpu")
    state, m = S.make_train_step(cfg, opt, accum_steps=accum)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_updates_close(
        dict(state.params.named_parameters()),
        named_from_jax(cfg, _np_tree(jstate.params), device="cpu"), opt.lr)


def test_train_step_matches_jax(case):
    _step(case, 1)


def test_train_step_with_two_microbatches_matches_jax():
    """accum 2 at qwen3's real heads: the q/k norms under gradient
    accumulation."""
    _step(_case("qwen3-32b", "real"), 2)
