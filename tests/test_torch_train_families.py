"""Training of every family the port serves, on the CPU, against the JAX
package: the smoke configs of falcon-mamba-7b (Mamba1), jamba-v0.1-52b
(the hybrid period with MoE), dbrx-132b (MoE with GQA),
deepseek-v2-lite-16b (MoE with MLA), internvl2-1b (``vit_stub``: patch
embeddings in place of the first positions, which the loss leaves out)
and musicgen-large (``encodec_stub``: (B,S,CB) tokens, the NLL averaged
over the codebooks), in float32 with the JAX weights of
``init_params(PRNGKey(0))`` carried over by ``params_from_jax``.

- loss, aux and every gradient against ``jax.value_and_grad`` of the
  JAX ``make_loss_fn``, at the tolerances of
  ``tests/test_torch_train.py::test_loss_and_gradients_match_jax`` (loss
  rtol 1e-5, each gradient within 1e-4 of its largest |g|);
- ``make_train_step`` (accum 1 and 2) against the JAX step (updated
  parameters at rtol 1e-4 / atol 1e-5, but for AdamW's sign flips:
  ``FLIPS``);
- a one-group ``HeteroDPTrainer`` step against ``make_train_step``;
- the rematerialised forward gives the gradients of the plain one
  (the MoE router recomputed in the backward routes as the forward did);
- ``launch.train --smoke --device cpu`` for each family.
Inputs are made with numpy from a seed."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import step as JS
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import DeviceGroup
from repro_torch.core.hetero_dp import HeteroDPTrainer
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.models.convert import (named_from_jax, params_from_jax,
                                        state_from_jax)
from repro_torch.optim import adamw as A
from repro_torch.optim.adamw import OptConfig
from repro_torch.training import step as S

ARCHS = ["falcon-mamba-7b", "jamba-v0.1-52b", "dbrx-132b",
         "deepseek-v2-lite-16b", "internvl2-1b", "musicgen-large"]
MOE = ("jamba-v0.1-52b", "dbrx-132b", "deepseek-v2-lite-16b")
B, L = 4, 32
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW's first step moves each element by about lr * g / (|g| + eps):
# where a gradient lies within the two sides' rounding of zero the move
# can differ by up to 2 lr.  Updated parameters are held to STEP_TOL but
# for at most FLIPS of a parameter's elements, each within 2 lr
FLIPS = 1e-3


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


def _model(arch):
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams


def _batch(cfg, seed, batch=B):
    """Numpy tokens (B, L), or (B, L, CB), and for ``vit_stub`` patches
    (B, n_patches, d)."""
    rng = np.random.default_rng(seed)
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, L) + cb).astype(np.int32)}
    if cfg.frontend == "vit_stub":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _assert_updates_close(got, want, lr):
    """Two updated models' parameters (name -> tensor): STEP_TOL but for
    at most FLIPS of each parameter's elements, each within 2 lr."""
    assert got.keys() == want.keys()
    for n in want:
        g = got[n].detach().double().numpy()
        w = want[n].detach().double().numpy()
        d = np.abs(g - w)
        outside = d > STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w)
        assert int(outside.sum()) <= FLIPS * d.size, (n, int(outside.sum()))
        assert float(d.max()) <= 2 * lr + STEP_TOL["atol"], n


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_gradients_match_jax(arch):
    cfg, jcfg, jparams = _model(arch)
    batch = _batch(cfg, 11)
    (jtotal, jm), jgrads = jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(cfg, _np_tree(jparams), "cpu")
    params.requires_grad_(True)
    (total, m), grads = S.make_grad_fn(cfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    assert (float(m["aux"]) > 0) == (arch in MOE)
    want = named_from_jax(cfg, _np_tree(jgrads), device="cpu")
    assert grads.keys() == want.keys()
    for n, w in want.items():
        top = float(w.abs().max())
        assert float((grads[n] - w).abs().max()) <= 1e-4 * top, n


def test_vlm_loss_leaves_the_patch_positions_out():
    """The next-token NLL at positions < n_patches does not enter the
    loss: tokens there change nothing, tokens after them do."""
    cfg = get_smoke("internvl2-1b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    loss_fn = S.make_loss_fn(cfg)
    with torch.no_grad():
        base = float(loss_fn(params, batch)[1]["loss"])
        early = dict(batch, tokens=batch["tokens"].clone())
        # the targets of positions 0 .. n_patches-2
        early["tokens"][:, 1:cfg.n_patches] = 0
        late = dict(batch, tokens=batch["tokens"].clone())
        late["tokens"][:, cfg.n_patches + 1] = 0
        assert float(loss_fn(params, early)[1]["loss"]) == base
        assert float(loss_fn(params, late)[1]["loss"]) != base


def test_audio_loss_averages_the_codebooks():
    """musicgen's loss is the mean over (positions, codebooks) of each
    codebook's next-frame NLL."""
    cfg = get_smoke("musicgen-large")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(cfg, 3)["tokens"])
    with torch.no_grad():
        loss = S.make_loss_fn(cfg)(params, {"tokens": toks})[1]["loss"]
        logits, _ = T.forward(cfg, params, toks)
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -lp.gather(-1, toks[:, 1:, :, None].long())[..., 0]
    assert nll.shape == (B, L - 1, cfg.n_codebooks)
    np.testing.assert_allclose(float(loss), float(nll.mean()), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "musicgen-large",
                                  "internvl2-1b"])
def test_train_step_matches_jax(arch, accum):
    cfg, jcfg, jparams = _model(arch)
    kw = dict(lr=1e-3, warmup_steps=1)
    opt, jopt = OptConfig(**kw), JA.OptConfig(**kw)
    batch = _batch(cfg, 5)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, accum_steps=accum))
    jstate, jm = jstep(JA.init_state(jparams, jopt),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    state = state_from_jax(cfg, _np_tree(JA.init_state(jparams, jopt)),
                           "cpu")
    state, m = S.make_train_step(cfg, opt, accum_steps=accum)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_updates_close(
        dict(state.params.named_parameters()),
        named_from_jax(cfg, _np_tree(jstate.params), device="cpu"), opt.lr)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "internvl2-1b"])
def test_hetero_step_with_one_group_equals_train_step(arch):
    """One group and one packet of the whole global batch: the step of
    ``make_train_step`` on ``batch_at(0)`` (to rounding: the packet runs
    on the group's thread)."""
    cfg = get_smoke(arch)
    shape = ShapeConfig("tiny", seq_len=L, global_batch=B, kind="train")
    opt = OptConfig(lr=2e-3, warmup_steps=1, total_steps=100)
    pipeline = SyntheticPipeline(cfg, shape)
    state = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)),
                         opt)
    ref = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)),
                       opt)
    trainer = HeteroDPTrainer(cfg, opt, shape,
                              [DeviceGroup("a", device="cpu")], pipeline,
                              lws=B)
    try:
        state, rep = trainer.step(state, 0)
    finally:
        trainer.close()
    batch = {k: torch.from_numpy(v)
             for k, v in pipeline.batch_at(0).items()}
    ref, m = S.make_train_step(cfg, opt)(ref, batch)
    assert rep.packets == 1 and rep.tokens == B * L
    # the trainer reports the objective, as the JAX package's does
    np.testing.assert_allclose(
        rep.loss, float(m["loss"]) + S.AUX_WEIGHT * float(m["aux"]),
        rtol=1e-6)
    _assert_updates_close(dict(state.params.named_parameters()),
                          dict(ref.params.named_parameters()), opt.lr)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "dbrx-132b"])
def test_remat_gives_the_plain_forwards_gradients(arch):
    """Each layer under ``torch.utils.checkpoint`` reruns the scan and the
    router in the backward: the gradients equal those of the forward
    without remat, bit for bit on the host."""
    cfg = replace(get_smoke(arch), moe=replace(get_smoke(arch).moe,
                                               capacity_factor=1.0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    toks = torch.from_numpy(_batch(cfg, 6)["tokens"])
    names, leaves = zip(*params.named_parameters())
    out = {}
    for remat in (True, False):
        logits, aux = T.forward(cfg, params, toks, remat=remat)
        out[remat] = torch.autograd.grad(
            logits.float().square().mean() + aux, leaves)
    for n, a, b in zip(names, out[True], out[False]):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "dbrx-132b", "internvl2-1b",
                                  "musicgen-large"])
def test_launch_train_smoke_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "16", "--batch", "4", "--log-every", "1"]
    if arch == "jamba-v0.1-52b":
        argv += ["--hetero", "a:1,b:2"]
    assert LT.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={get_smoke(arch).name}" in out
    assert "step     1 loss=" in out and "nan" not in out
