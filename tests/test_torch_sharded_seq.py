"""Sequence parallelism and the "global" MoE dispatch under a "data"
split against the JAX package, on the CPU: four ``gloo`` ranks on the
("data", "model") = (2, 2) mesh (``parallel/spmd.py``), one spawned rank
set for every case (``tests/_seq_rank.py``).

* A microbatch whose rows "data" does not divide (a batch of one row, or
  two microbatches of one) puts its positions on "data", as the JAX
  rule ``"seq": [("data",)]`` does: each "data" rank holds a stretch of
  16 of the 32 positions.  llama3.2-1b and internvl2-1b (20 patches,
  across the stretches' boundary) gather the earlier keys and values,
  deepseek-v2-lite-16b its latent rows, falcon-mamba-7b and jamba take
  the conv's halo and the scan's state from the earlier stretch, and the
  MoE dispatch counts the earlier stretch's slots.
* The "global" dispatch (deepseek-v2-lite-16b, jamba) under a row split
  (a batch of 4) and under a position split (a batch of 1).

Each against the JAX package's unsharded ``jax.value_and_grad
(make_loss_fn(cfg))`` and ``make_train_step`` on the whole batch, at
``tests/test_torch_sharded_data.py``'s ``TOL`` (rtol = atol = 2e-4): the
loss, every gradient made whole, the step's loss and norm, and one AdamW
step.  The dispatch's routing and kept slots on a rank's part of the
batch equal the whole batch's, checked in one process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _seq_rank as Q
import _sharded_rank as SR
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import step as JS
from repro_torch.configs import get_smoke
from repro_torch.models import layers as L
from repro_torch.models.convert import named_from_jax, whole_from_ranks
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import ShardingResolver
from test_torch_train_families import _assert_updates_close

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESH = Q.mesh(Q.SEQ_MESH)
IDS = [c[0] for c in Q.SEQ_CASES]
TOL = dict(rtol=2e-4, atol=2e-4)
RANKS_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def batch_of(cfg, rows, length=Q.L):
    """Numpy tokens (rows, length) and, for ``vit_stub``, patches."""
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, length)).astype(np.int32)}
    if cfg.frontend == "vit_stub":
        out["patches"] = rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def jax_train(case, jparams, batch):
    """The JAX package's unsharded loss, gradients and one train step."""
    jcfg = Q.case_config(jax_get_smoke, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, m), grads = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True))(jparams, jb)
    jopt = JA.OptConfig(**Q.OPT)
    state, sm = jax.jit(JS.make_train_step(jcfg, jopt,
                                           accum_steps=case[5]))(
        JA.init_state(jparams, jopt), jb)
    return dict(total=float(total), loss=float(m["loss"]),
                aux=float(m["aux"]), grads=_np(grads),
                params=_np(state.params),
                metrics={k: float(v) for k, v in sm.items()})


def save_cases(case_dir, cases):
    """Each case's JAX parameters and batch into ``case_dir``, and the
    JAX package's results by case id."""
    want = {}
    for case in cases:
        jcfg = Q.case_config(jax_get_smoke, case)
        jparams = _np(JT.init_params(jcfg, jax.random.PRNGKey(0))[0])
        batch = batch_of(jcfg, case[4], Q.case_length(case))
        np.savez(case_dir / f"train-{case[0]}.npz", **SR.flatten(jparams),
                 **{f"__{k}__": v for k, v in batch.items()})
        want[case[0]] = jax_train(case, jparams, batch)
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("sharded_seq")
    want = save_cases(case_dir, Q.SEQ_CASES)
    got = spmd.run(Q.seq_cases, Q.WORLD, store_dir=str(case_dir),
                   backend="gloo", device="cpu", args=(str(case_dir),),
                   timeout=RANKS_TIMEOUT_S)
    return want, got


def case_of(cid, cases=Q.SEQ_CASES):
    return next(c for c in cases if c[0] == cid)


def whole(case, mesh, got, key):
    cfg = Q.case_config(get_smoke, case)
    return whole_from_ranks(cfg, mesh, [
        {k: torch.from_numpy(v) for k, v in r["train"][case[0]][key].items()}
        for r in got], resolver=ShardingResolver(mesh, fsdp=True))


def check_case(want, got, case, mesh):
    """The loss, the gradients made whole (one microbatch), the step's
    metrics and its updated weights, against the JAX package's."""
    cid = case[0]
    w = want[cid]
    cfg = Q.case_config(get_smoke, case)
    for r in got:
        mine = r["train"][cid]
        if "total" in mine:
            for k in ("total", "loss", "aux"):
                np.testing.assert_allclose(mine[k], w[k], **TOL)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(mine["metrics"][k], w["metrics"][k],
                                       **TOL)
    if "grads" in got[0]["train"][cid]:
        grads = whole(case, mesh, got, "grads")
        ref = named_from_jax(cfg, w["grads"], device="cpu")
        assert grads.keys() == ref.keys()
        for n, g in ref.items():
            np.testing.assert_allclose(grads[n].numpy(), g.numpy(), **TOL,
                                       err_msg=n)
    _assert_updates_close(whole(case, mesh, got, "params"),
                          named_from_jax(cfg, w["params"], device="cpu"),
                          Q.OPT["lr"])


@pytest.mark.parametrize("cid", IDS)
def test_train_matches_jax(ranks, cid):
    check_case(*ranks, case_of(cid), MESH)


@pytest.mark.parametrize("cid", IDS)
def test_each_rank_holds_its_part(ranks, cid):
    """A batch "data" divides gives each "data" rank its rows, one it
    does not a stretch of every row, one whose positions it does not
    divide either every token; the loss and norm are the same bits on
    the four ranks."""
    case = case_of(cid)
    n = case[4] // case[5]
    _, got = ranks
    for r, out in enumerate(got):
        mine = out["train"][cid]
        d = r // 2
        if Q.case_length(case) % 2:
            assert (mine["rows"], mine["stretch"], mine["axes"]) == (
                (0, n), None, ())
        elif n % 2:
            assert mine["axes"] == ("data",)
            assert mine["rows"] == (0, n) and mine["stretch"] == (16 * d, 16)
        else:
            assert mine["axes"] == ("data",)
            assert mine["rows"] == (d * n // 2, (d + 1) * n // 2)
            assert mine["stretch"] is None
        assert mine["metrics"] == got[0]["train"][cid]["metrics"]


def test_ranks_import_neither_jax_nor_repro(ranks):
    for r in ranks[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


# ------------------------------------------- the dispatch on one process
class _Split:
    """Stands in for a rank's ``res`` in the dispatch: its part of the
    batch, the other parts' expert counts (as ``gather_counts`` returns
    them) and its index among them."""

    def __init__(self, parts_counts, index, stretch):
        self.counts, self.index, self.stretch = parts_counts, index, stretch

    def token_group(self):
        return object()

    def gather_counts(self, counts):
        assert torch.equal(counts, self.counts[self.index])
        return self.counts, self.index


@pytest.mark.parametrize("dispatch, split", [
    ("global", "rows"), ("global", "seq"), ("grouped", "seq")])
def test_dispatch_slots_match_the_whole_batch(dispatch, split):
    """deepseek's routed experts at a capacity factor that drops tokens:
    each of two parts of a batch (its rows, or its positions) routes
    every token to the whole batch's experts and keeps the whole batch's
    slots, so its output is the whole batch's rows or positions."""
    import dataclasses
    cfg = get_smoke("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch, capacity_factor=0.5, n_shared=0))
    gen = torch.Generator().manual_seed(0)
    p = L.moe_init(cfg, gen, torch.float32)
    x = torch.randn(4, 16, cfg.d_model, generator=gen)
    fn = (L._moe_global_dispatch if dispatch == "global"
          else L._moe_grouped_dispatch)
    want, _, _ = fn(cfg, p, x)
    parts = (x[:2], x[2:]) if split == "rows" else (x[:, :8], x[:, 8:])
    counts = torch.stack([L._expert_counts(
        L.moe_route(cfg, p, part)[2], cfg.moe.n_routed) for part in parts])
    for i, part in enumerate(parts):
        stretch = None if split == "rows" else (8 * i, 8)
        got, _, _ = fn(cfg, p, part, res=_Split(counts, i, stretch))
        ref = want[2 * i:2 * i + 2] if split == "rows" else (
            want[:, 8 * i:8 * i + 8])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # the capacity drops choices: without it the output differs
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    assert not torch.allclose(fn(roomy, p, x)[0], want)
