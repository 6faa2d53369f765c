"""The port's training slice against the JAX package, on the CPU: the
smoke ``llama3.2-1b`` in float32, with the JAX weights, moments and
gradients carried over by ``params_from_jax`` / ``named_from_jax`` /
``state_from_jax``.

- the data pipeline's batches are byte-equal;
- ``lr_at`` and three ``apply_updates`` steps agree at rtol 1e-6 /
  atol 1e-7; ``compress_decompress`` gives the same int8 codes exactly
  and error buffers within one bfloat16 ulp;
- the loss agrees at rtol 1e-5 and every parameter's gradient within
  1e-4 of that leaf's largest |g|; a ``make_train_step`` step (accum 1
  and 2, compression on and off) gives updated parameters within rtol
  1e-4 / atol 1e-5;
- rematerialisation changes no gradient (bitwise on the CPU), and
  ``param_count`` equals the JAX package's;
- ``HeteroDPTrainer`` on host groups behaves as ``tests/test_hetero_dp.py``
  holds the JAX one to, and checkpoints as ``tests/test_ckpt.py`` holds
  the JAX ones to, with ``launch.train`` driven end to end.
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import transformer as JT
from repro.optim import adamw as JA, compress as JC
from repro.training import step as JS
from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import DeviceGroup
from repro_torch.core.hetero_dp import HeteroDPTrainer
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.models.convert import (named_from_jax, params_from_jax,
                                        state_from_jax)
from repro_torch.optim import adamw as A, compress as C
from repro_torch.optim.adamw import OptConfig
from repro_torch.training import step as S

ARCH = "llama3.2-1b"
SHAPE = ShapeConfig("tiny", seq_len=32, global_batch=16, kind="train")
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


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
    cfg, jcfg = get_smoke(ARCH), jax_get_smoke(ARCH)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(cfg, tree):
    return named_from_jax(cfg, _np_tree(tree), device="cpu")


def _assert_named_close(got, want, **tol):
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n].detach().float().numpy(),
                                   want[n].detach().float().numpy(),
                                   err_msg=n, **tol)


def _tokens(cfg, B, L, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("rows", [None, (0, 3), (3, 16), (5, 6)])
def test_pipeline_batches_byte_equal(step, rows):
    cfg, jcfg = get_smoke(ARCH), jax_get_smoke(ARCH)
    mine = SyntheticPipeline(cfg, SHAPE)
    ref = JPipeline(jcfg, JShapeConfig("tiny", 32, 16, "train"))
    sl = slice(*rows) if rows else None
    got, want = mine.batch_at(step, sl), ref.batch_at(step, sl)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    assert got["tokens"].tobytes() == want["tokens"].tobytes()
    if rows:
        np.testing.assert_array_equal(
            mine.slice_rows(step, rows[0], rows[1] - rows[0])["tokens"],
            want["tokens"])


def test_pipeline_iterator_prefetches_the_same_stream():
    cfg = get_smoke(ARCH)
    p = SyntheticPipeline(cfg, SHAPE)
    it = p.iterator(start_step=2, depth=2)
    for s in (2, 3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      p.batch_at(s)["tokens"])


# --------------------------------------------------------------- optimizer
def test_lr_schedule_matches_jax():
    opt = OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jopt = JA.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = A.lr_at(opt, torch.tensor(s, dtype=torch.int32))
        want = JA.lr_at(jopt, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_apply_updates_matches_jax(smoke):
    """Three steps on the smoke weights with seeded numpy gradients; the
    first large enough to be clipped.  Every layer's norms decay as the
    JAX package's stacked (n_blocks, d) arrays do; ``final_norm`` does
    not."""
    cfg, jcfg, jparams = smoke
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    opt, jopt = OptConfig(**kw), JA.OptConfig(**kw)
    jstate = JA.init_state(jparams, jopt)
    state = A.init_state(params_from_jax(cfg, _np_tree(jparams), "cpu"),
                         opt)
    rng = np.random.default_rng(3)
    for i, mag in enumerate((10.0, 0.01, 0.1)):
        jg = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * mag)
                          .astype(np.float32), _np_tree(jparams))
        jstate, jm = JA.apply_updates(jstate, jax.tree.map(jnp.asarray, jg),
                                      jopt)
        state, m = A.apply_updates(state, _named(cfg, jg), opt)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    tol = dict(rtol=1e-6, atol=1e-7)
    _assert_named_close(dict(state.params.named_parameters()),
                        _named(cfg, jstate.params), **tol)
    for tree in ("mu", "nu"):
        got = getattr(state, tree)
        assert all(t.dtype == torch.float32 for t in got.values())
        _assert_named_close(got, _named(cfg, getattr(jstate, tree)), **tol)


@pytest.mark.parametrize("with_err", [False, True])
def test_compress_codes_equal_jax(smoke, with_err):
    """Seeded gradients of the smoke model's structure: the reference
    takes one scale per array of its tree (all layers' same-named
    parameters stacked in one), and the port's codes equal its codes."""
    cfg, _, jparams = smoke
    rng = np.random.default_rng(7 + with_err)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                    * rng.uniform(1e-3, 3.0))
                         .astype(np.float32), _np_tree(jparams))
    err = (jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-4)
                        .astype(np.float32), _np_tree(jparams))
           if with_err else None)
    jdeq, jnew = JC.compress_decompress(
        jax.tree.map(jnp.asarray, grads),
        jax.tree.map(lambda e: jnp.asarray(e, jnp.bfloat16), err)
        if with_err else None)
    tg = _named(cfg, grads)
    terr = ({n: e.to(torch.bfloat16) for n, e in _named(cfg, err).items()}
            if with_err else None)
    deq, new = C.compress_decompress(tg, terr)
    g32 = {n: g + (terr[n].float() if with_err else 0.0)
           for n, g in tg.items()}
    top = {}
    for n, x in g32.items():
        k = C._scale_group(n)
        top[k] = torch.maximum(top.get(k, x.abs().max()), x.abs().max())
    want_deq, want_err = _named(cfg, jdeq), _named(
        cfg, jax.tree.map(lambda e: e.astype(jnp.float32), jnew))
    assert deq.keys() == want_deq.keys()
    for n, x in g32.items():
        codes, scale = C.quantize(x, top[C._scale_group(n)])
        assert codes.dtype == torch.int8 and int(codes.abs().max()) <= 127
        # the reference's dequantized values are its codes times the scale
        assert torch.equal(codes.float() * scale, want_deq[n]), n
        assert torch.equal(deq[n], want_deq[n]), n
        assert new[n].dtype == torch.bfloat16
        got, want = new[n].float(), want_err[n]
        # within one bfloat16 ulp of the reference's error buffer
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp(min=1e-30))) - 7)
        assert bool(((got - want).abs() <= ulp).all()), n


# ---------------------------------------------------- loss and gradients
def test_loss_and_gradients_match_jax(smoke):
    cfg, jcfg, jparams = smoke
    toks = _tokens(cfg, 4, 32, 11)
    (jtotal, jm), jgrads = jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True)(jparams,
                                             {"tokens": jnp.asarray(toks)})
    params = params_from_jax(cfg, _np_tree(jparams), "cpu")
    params.requires_grad_(True)
    (total, m), grads = S.make_grad_fn(cfg)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = _named(cfg, jgrads)
    assert grads.keys() == want.keys()
    for n, w in want.items():
        top = float(w.abs().max())
        assert float((grads[n] - w).abs().max()) <= 1e-4 * top, n


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(smoke, accum, compress):
    cfg, jcfg, jparams = smoke
    kw = dict(lr=1e-3, warmup_steps=1)
    opt, jopt = OptConfig(**kw), JA.OptConfig(**kw)
    toks = _tokens(cfg, 4, 32, 5)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, accum_steps=accum,
                                       compress=compress))
    jstate, jm = jstep(JA.init_state(jparams, jopt),
                       {"tokens": jnp.asarray(toks)})
    state = state_from_jax(cfg, _np_tree(JA.init_state(jparams, jopt)),
                           "cpu")
    state, m = S.make_train_step(cfg, opt, accum_steps=accum,
                                 compress=compress)(
        state, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_named_close(dict(state.params.named_parameters()),
                        _named(cfg, jstate.params), **STEP_TOL)


def test_remat_gives_bitwise_equal_gradients(smoke):
    cfg, _, jparams = smoke
    toks = torch.from_numpy(_tokens(cfg, 2, 32, 2))
    params = params_from_jax(cfg, _np_tree(jparams), "cpu")
    params.requires_grad_(True)
    names, leaves = zip(*params.named_parameters())
    out = {}
    for remat in (True, False):
        logits, _ = T.forward(cfg, params, toks, remat=remat)
        out[remat] = torch.autograd.grad(logits.float().square().mean(),
                                         leaves)
    for n, a, b in zip(names, out[True], out[False]):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("policy", ["dots", "everything"])
def test_remat_policies_give_equal_gradients(smoke, policy):
    cfg, _, jparams = smoke
    toks = torch.from_numpy(_tokens(cfg, 2, 32, 4))
    params = params_from_jax(cfg, _np_tree(jparams), "cpu")
    params.requires_grad_(True)
    leaves = list(params.parameters())
    grads = {}
    for c in (cfg, replace(cfg, remat_policy=policy)):
        logits, _ = T.forward(c, params, toks)
        grads[c.remat_policy] = torch.autograd.grad(
            logits.float().square().mean(), leaves)
    for a, b in zip(grads["nothing"], grads[policy]):
        assert torch.equal(a, b)


def test_param_count_matches_jax():
    from repro.configs import get_config as jget
    counted = 0
    for arch in ARCH_IDS:
        for cfg, jcfg in ((get_config(arch), jget(arch)),
                          (get_smoke(arch), jax_get_smoke(arch))):
            try:
                T.check_supported(cfg)
            except NotImplementedError:
                continue
            assert T.param_count(cfg) == JT.param_count(jcfg), cfg.name
            counted += 1
    assert counted == 20          # all 10 configs, full + smoke
    assert T.param_count(get_config(ARCH))[0] == 1_235_814_400


def test_state_from_jax_carries_a_bfloat16_state():
    """The published configs train in bfloat16: a JAX state of bfloat16
    weights (numpy's ml_dtypes arrays) and float32 moments comes across
    with its dtypes and values."""
    cfg = replace(get_smoke(ARCH), dtype="bfloat16")
    jcfg = replace(jax_get_smoke(ARCH), dtype="bfloat16")
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = JA.init_state(jparams, JA.OptConfig())
    jstate = jstate._replace(step=jnp.asarray(3, jnp.int32),
                             mu=jax.tree.map(lambda m: m + 0.25, jstate.mu))
    state = state_from_jax(cfg, _np_tree(jstate), "cpu")
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    want = _named(cfg, jax.tree.map(lambda x: x.astype(jnp.float32),
                                    jparams))
    for n, p in state.params.named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        assert torch.equal(p.detach().float(), want[n]), n
    assert all(m.dtype == torch.float32 and bool((m == 0.25).all())
               for m in state.mu.values())


def test_prefill_and_decode_steps_wrap_the_cached_paths(smoke):
    cfg, _, jparams = smoke
    params = params_from_jax(cfg, _np_tree(jparams), "cpu")
    params.requires_grad_(True)          # a training state's parameters
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 9))
    prefill, decode = S.make_prefill_step(cfg), S.make_decode_step(cfg)
    cache = T.init_cache(cfg, 2, 12, device="cpu")
    lg, cache = prefill(params, {"tokens": toks[:, :10]}, cache)
    lg2, _ = decode(params, toks[:, 10:11], cache, 10)
    with torch.inference_mode():
        ref = T.init_cache(cfg, 2, 12, device="cpu")
        want, ref = T.prefill(cfg, params, toks[:, :10], ref)
        want2, _ = T.decode_step(cfg, params, toks[:, 10:11], ref, 10)
    assert not lg.requires_grad and not lg2.requires_grad
    assert torch.equal(lg, want) and torch.equal(lg2, want2)


# ------------------------------------------------------------- hetero DP
def make_trainer(devices, **kw):
    cfg = get_smoke(ARCH)
    pipeline = SyntheticPipeline(cfg, SHAPE)
    opt = OptConfig(lr=2e-3, warmup_steps=1, total_steps=100)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    state = A.init_state(params, opt)
    trainer = HeteroDPTrainer(cfg, opt, SHAPE, devices, pipeline, **kw)
    return trainer, state


def cpu_group(name, **kw):
    return DeviceGroup(name, device="cpu", **kw)


def test_hetero_training_loss_decreases():
    trainer, state = make_trainer([cpu_group("a", throttle=1.0),
                                   cpu_group("b", throttle=2.0)])
    losses = []
    try:
        for i in range(6):
            state, rep = trainer.step(state, i)
            losses.append(rep.loss)
            assert rep.tokens == SHAPE.global_batch * SHAPE.seq_len
    finally:
        trainer.close()
    assert losses[-1] < losses[0]


def test_hetero_rows_proportional_to_speed():
    trainer, state = make_trainer([cpu_group("fast", throttle=1.0),
                                   cpu_group("slow", throttle=4.0)])
    total = {"fast": 0, "slow": 0}
    try:
        for i in range(4):
            state, rep = trainer.step(state, i)
            for k, v in rep.device_rows.items():
                total[k] += v
    finally:
        trainer.close()
    assert total["fast"] > total["slow"]


def test_hetero_failure_mid_training_absorbed():
    trainer, state = make_trainer([cpu_group("a", throttle=1.0),
                                   cpu_group("b", throttle=1.0,
                                             fail_after=1)])
    try:
        state, rep = trainer.step(state, 0)      # b dies after 1 packet
        assert rep.failures == 1
        assert rep.tokens == SHAPE.global_batch * SHAPE.seq_len
        state, rep2 = trainer.step(state, 1)
        assert rep2.tokens == SHAPE.global_batch * SHAPE.seq_len
    finally:
        trainer.close()


def test_hetero_elastic_add_remove():
    trainer, state = make_trainer([cpu_group("a", throttle=1.0)])
    try:
        state, _ = trainer.step(state, 0)
        trainer.add_device(cpu_group("b", throttle=1.0))
        state, rep2 = trainer.step(state, 1)
        assert set(rep2.device_rows) == {"a", "b"}
        trainer.remove_device("b")
        state, rep3 = trainer.step(state, 2)
        assert set(rep3.device_rows) == {"a"}
    finally:
        trainer.close()


def test_hetero_compressed_gradients_still_learn():
    trainer, state = make_trainer([cpu_group("a", throttle=1.0)],
                                  compress=True)
    losses = []
    try:
        for i in range(6):
            state, rep = trainer.step(state, i)
            losses.append(rep.loss)
    finally:
        trainer.close()
    assert losses[-1] < losses[0]


def test_hetero_step_with_one_group_equals_train_step():
    """One group and one packet of the whole global batch (``lws`` = the
    batch: the pipeline draws a row range from its own seed, so only the
    whole range is ``batch_at(step)``): the same step as
    ``make_train_step`` (to rounding: the packet runs on the group's
    thread, whose BLAS may split the products otherwise)."""
    trainer, state = make_trainer([cpu_group("a")],
                                  lws=SHAPE.global_batch)
    cfg, opt = trainer.cfg, trainer.opt
    ref = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)),
                       opt)
    try:
        state, rep = trainer.step(state, 0)
    finally:
        trainer.close()
    batch = {k: torch.from_numpy(v)
             for k, v in trainer.pipeline.batch_at(0).items()}
    ref, m = S.make_train_step(cfg, opt)(ref, batch)
    assert rep.packets == 1
    np.testing.assert_allclose(rep.loss, float(m["loss"]), rtol=1e-6)
    assert int(state.step) == int(ref.step) == 1
    _assert_named_close(dict(state.params.named_parameters()),
                        dict(ref.params.named_parameters()), **STEP_TOL)


# ------------------------------------------------------------ checkpoints
def make_state():
    cfg = get_smoke(ARCH)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    return A.init_state(params, OptConfig())


def _leaves(state):
    return CK._flatten(state)


def test_ckpt_roundtrip(tmp_path):
    state = make_state()
    with torch.no_grad():
        for i, t in enumerate(state.mu.values()):
            t.fill_(0.5 * i)
    CK.save(state, str(tmp_path), 7)
    assert CK.latest_step(str(tmp_path)) == 7
    fresh = make_state()
    restored, step = CK.restore(fresh, str(tmp_path))
    assert step == 7 and restored is fresh
    a, b = _leaves(state), _leaves(restored)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    man = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"hosts": 1' in man and '"float32"' in man


def test_ckpt_incomplete_checkpoint_ignored(tmp_path):
    state = make_state()
    CK.save(state, str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000009")       # a torn write: no COMMIT
    assert CK.latest_step(str(tmp_path)) == 1


def test_ckpt_gc_keeps_latest(tmp_path):
    state = make_state()
    for s in range(5):
        CK.save(state, str(tmp_path), s, keep=2)
    assert sorted(CK.all_steps(str(tmp_path))) == [3, 4]


def test_ckpt_async_checkpointer(tmp_path):
    state = make_state()
    ck = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(state, 11)
    with torch.no_grad():          # the snapshot was taken at save()
        next(state.params.parameters()).add_(1.0)
    ck.wait()
    assert CK.latest_step(str(tmp_path)) == 11
    restored, _ = CK.restore(make_state(), str(tmp_path))
    assert torch.equal(next(restored.params.parameters()),
                       next(make_state().params.parameters()))


def test_ckpt_restore_rejects_another_shape(tmp_path):
    CK.save(make_state(), str(tmp_path), 3)
    cfg = replace(get_smoke(ARCH), d_ff=96)
    other = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)),
                         OptConfig())
    with pytest.raises(ValueError, match="shape"):
        CK.restore(other, str(tmp_path))


def test_ckpt_restart_resumes_training(tmp_path):
    """Save mid-run, restore into a fresh state, verify training continues
    from the same point (deterministic data => identical next step)."""
    cfg = get_smoke(ARCH)
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    state = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)),
                         opt)
    step_fn = S.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32, 5))}
    state, _ = step_fn(state, batch)
    CK.save(state, str(tmp_path), int(state.step))
    fresh = A.init_state(T.init_params(cfg, torch.Generator().manual_seed(1)),
                         opt)
    restored, step = CK.restore(fresh, str(tmp_path))
    assert step == 1 and int(restored.step) == 1
    s1, m1 = step_fn(state, batch)
    s2, m2 = step_fn(restored, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "4",
              "--log-every", "1", "--ckpt-dir", ck]
    assert LT.main(common + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and f"checkpoint at {ck} step 3" in out
    assert CK.latest_step(ck) == 3
    assert LT.main(common + ["--steps", "5", "--resume", "--hetero",
                             "a:1,b:2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     4 loss=" in out
    assert "step     2 loss=" not in out
    assert CK.latest_step(ck) == 5
