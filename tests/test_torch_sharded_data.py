"""Meshes with "data" above 1 against the JAX package, on the CPU: four
``gloo`` ranks on the ("data", "model") = (2, 2) mesh
(``parallel/spmd.py``), the batch split over "data", each rank holding
its block of the weights.  One spawned rank set runs every case.

* Training: the twelve cases of ``tests/_sharded_train_rank.py`` at B =
  4 (2 rows a "data" rank; jamba-v0.1-52b at two microbatches), under the
  FSDP resolver: each weight's block split over "data" too, gathered
  before use and its gradient reduce-scattered after.  Each is held
  against the JAX package's unsharded ``jax.value_and_grad(make_loss_fn
  (cfg))`` and ``make_train_step`` on the whole batch, at the tolerances
  of ``tests/test_torch_sharded_train.py``: the loss, each gradient made
  whole (``convert.whole_from_ranks`` with the ranks' resolver),
  ``grad_norm`` (with clipping too) and one AdamW step (with
  compression too).  FSDP really splits: every config has blocks halved
  along a "data" dim.  The loss and norm are bitwise equal on the four
  ranks.
* Serving, with the tensor-parallel resolver of decode: the parity sets
  of ``tests/_sharded_rank.py`` (B = 4) and ``tests/_kvseq_rank.py`` (B =
  2, caches split by position and whole), each rank's rows of the
  prefill's and decode steps' logits against the JAX package's unsharded
  steps at rtol = atol = 2e-4, the two "model" ranks of each "data" pair
  bitwise equal; a batch of 1, which "data" does not divide, served
  replicated over "data"; dbrx-132b's ``serve_2d_weights`` prefill from
  FSDP blocks.
* The planner's rank-0 train step on (2, 2) predicts the collectives
  the ranks count, kind by kind; the JAX package's smoke llama train step
  compiled on a forced (2, 2) host mesh with the FSDP resolver has its
  gathers and reduce-scatters pinned beside the port's.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _data_rank as DR
import _kvseq_rank as K
import _sharded_rank as SR
import _sharded_train_rank as TR
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import card_mesh, coords
from repro_torch.models.convert import named_from_jax, whole_from_ranks
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel import spmd
from repro_torch.parallel.collectives import sharded_run
from repro_torch.parallel.sharding import ShardingResolver
from test_torch_dense_configs import _seeded_norms
from test_torch_sharded import _jax_logits
from test_torch_sharded_kvseq import _jax_run
from test_torch_sharded_train import _batch, _jax_case
from test_torch_train_families import _assert_updates_close

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESH = card_mesh("h100x2x2")
IDS = [c[0] for c in TR.CASES]
TOL = dict(rtol=2e-4, atol=2e-4)
# one spawned rank set runs every case
RANKS_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# the JAX package's train step of the smoke llama (8/4 heads) at B = 4, S
# = 32, compiled on a forced (2, 2) host mesh with the FSDP resolver the
# JAX dry run trains with
JAX_DATA_COLLECTIVES = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch import hlo_cost
from repro.launch import specs as SP
from repro.optim.adamw import OptConfig
from repro.parallel.sharding import ShardingResolver
from repro.training import step as STEP

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = ShardingResolver(mesh, fsdp=True)


def is_ax(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree(axes, abst, param):
    return jax.tree.map(lambda ax, l: res.sharding(ax, l.shape, param=param),
                        axes, abst, is_leaf=is_ax)


cfg = dataclasses.replace(get_smoke("llama3.2-1b"), n_heads=8, n_kv_heads=4)
opt = OptConfig()
st, st_ax = SP.abstract_train_state(cfg, opt)
shape = ShapeConfig("t", %d, %d, "train")
ins = SP.input_specs(cfg, shape)
fn = jax.jit(STEP.make_train_step(cfg, opt, res=res),
             in_shardings=(tree(st_ax, st, True),
                           tree(SP.batch_logical_axes(cfg, shape), ins,
                                False)))
with mesh:
    out = hlo_cost.analyze(fn.lower(st, ins).compile().as_text())
print(json.dumps(out["collectives"]))
""" % (TR.L, TR.B)


@pytest.fixture(scope="module")
def jax_compile():
    """The subprocess that compiles the JAX train step, started before
    the ranks so that the two run together."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_DATA_COLLECTIVES],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _serve_tokens(cfg, shape):
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, shape + cb).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_compile):
    """The JAX package's results by case, and the four ranks'."""
    case_dir = tmp_path_factory.mktemp("sharded_data")
    train = {}
    for case in TR.CASES:
        jcfg = TR.case_config(jax_get_smoke, case)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jparams = _seeded_norms(_np_tree(jparams), np.random.default_rng(3))
        batch = _batch(jcfg)
        np.savez(case_dir / f"train-{case[0]}.npz", **SR.flatten(jparams),
                 **{f"__{k}__": v for k, v in batch.items()})
        train[case[0]] = _jax_case(case, jparams, batch)
    serve = {}
    for arch in SR.ARCHS:
        jcfg = SR.with_heads(jax_get_smoke(arch))
        jparams = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(0))[0])
        tokens = _serve_tokens(jcfg, (SR.B, SR.P + SR.STEPS))
        np.savez(case_dir / f"serve-{arch}.npz", __tokens__=tokens,
                 **SR.flatten(jparams))
        serve[arch] = dict(logits=_jax_logits(jcfg, jparams, tokens))
    for arch in K.ARCHS:
        jcfg = DR.kvseq_config(jax_get_smoke, arch)
        jparams = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(0))[0])
        tokens = _serve_tokens(jcfg, (K.B, K.P + K.STEPS))
        np.savez(case_dir / f"kvseq-{arch}.npz", __tokens__=tokens,
                 **SR.flatten(jparams))
        serve[arch] = dict(split=_jax_run(jcfg, jparams, tokens,
                                          K.SPLIT_SEQ)[0],
                           kept=_jax_run(jcfg, jparams, tokens,
                                         K.WHOLE_SEQ)[0])
    got = spmd.run(DR.data_cases, DR.WORLD, store_dir=str(case_dir),
                   backend="gloo", device="cpu", args=(str(case_dir),),
                   timeout=RANKS_TIMEOUT_S)
    return dict(train=train, serve=serve), got


def _cfg(cid):
    return TR.case_config(get_smoke, next(c for c in TR.CASES
                                          if c[0] == cid))


def _whole(cid, got, key):
    cfg = _cfg(cid)
    return whole_from_ranks(cfg, MESH, [
        {k: torch.from_numpy(v) for k, v in r["train"][cid][key].items()}
        for r in got], resolver=ShardingResolver(MESH, fsdp=True))


# ------------------------------------------------------------ training
@pytest.mark.parametrize("cid", IDS)
def test_loss_matches_jax(ranks, cid):
    want, got = ranks
    w = want["train"][cid]
    for r in got:
        for k in ("total", "loss", "aux"):
            np.testing.assert_allclose(r["train"][cid][k], w[k], rtol=1e-5,
                                       atol=1e-7 if k == "aux" else 0)
    assert (w["aux"] > 0) == bool(_cfg(cid).moe.n_routed)


@pytest.mark.parametrize("cid", IDS)
def test_loss_and_norm_bitwise_equal_on_every_rank(ranks, cid):
    """Every rank's loss is the whole batch's, and so is its norm."""
    _, got = ranks
    first = got[0]["train"][cid]
    for r in got[1:]:
        mine = r["train"][cid]
        assert (mine["total"], mine["loss"], mine["aux"]) == (
            first["total"], first["loss"], first["aux"])
        assert mine["metrics"] == first["metrics"]


@pytest.mark.parametrize("cid", IDS)
def test_gradients_made_whole_match_jax(ranks, cid):
    want, got = ranks
    whole = _whole(cid, got, "grads")
    ref = named_from_jax(_cfg(cid), want["train"][cid]["grads"],
                         device="cpu")
    assert whole.keys() == ref.keys()
    for n, w in ref.items():
        top = float(w.abs().max())
        assert top > 0, n
        assert float((whole[n] - w).abs().max()) <= 1e-4 * top, n


@pytest.mark.parametrize("cid", IDS)
def test_train_step_matches_jax(ranks, cid):
    want, got = ranks
    wm = want["train"][cid]["metrics"]
    for r in got:
        m = r["train"][cid]["metrics"]
        np.testing.assert_allclose(m["loss"], wm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], wm["grad_norm"],
                                   rtol=1e-4)
    opt = OptConfig(**TR.OPT, **next(c for c in TR.CASES
                                     if c[0] == cid)[4])
    if cid.endswith("clipped"):
        assert wm["grad_norm"] > 10 * opt.clip_norm
    _assert_updates_close(_whole(cid, got, "params"),
                          named_from_jax(_cfg(cid),
                                         want["train"][cid]["params"],
                                         device="cpu"), opt.lr)


@pytest.mark.parametrize("cid", IDS)
def test_fsdp_splits_weights_over_data(ranks, cid):
    """Each config has blocks that "data" halves along the dim FSDP
    chose, beside the tensor-parallel block of the same weight; the two
    "data" ranks of a "model" rank hold its two halves."""
    _, got = ranks
    cfg = _cfg(cid)
    tp = sharded_run(cfg, MESH)            # the decode resolver: no FSDP
    from repro_torch.models import transformer as T
    abstract = T.init_abstract(cfg)
    tp_blocks = dict(T.shard_params(cfg, abstract, tp).named_parameters())
    for r, out in enumerate(got):
        fsdp = out["train"][cid]["fsdp"]
        assert fsdp, f"rank {r}: no weight split over 'data'"
        for name, dim in fsdp.items():
            block = out["train"][cid]["params"][name]
            assert block.shape[dim] * 2 == tp_blocks[name].shape[dim], name
            assert "data" in out["train"][cid]["split"][name], name


def test_ranks_import_neither_jax_nor_repro(ranks):
    for r in ranks[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


@pytest.mark.parametrize("cid", TR.PLANNED)
def test_plan_predicts_the_ranks_train_collectives(ranks, cid):
    """``plan`` on (2, 2) runs rank 0's train step on ``meta`` under the
    fake backend, its "model" and "data" groups made from it: the
    gathers, reduce-scatters and all-reduces equal those rank 0 counted
    in the real four-rank step of the same cell."""
    rec = D.plan(_cfg(cid), ShapeConfig("t", TR.L, TR.B, "train"), MESH)
    got = ranks[1][0]["train"][cid]["collectives"]
    assert got["reduce-scatter"]["count"] > 0 and got["all-gather"]
    assert rec["collectives"] == got == rec["sharded_step"]["collectives"]
    assert rec["sharded_step"]["predicted_peak_bytes"] == (
        rec["argument_bytes_per_device"]
        + rec["sharded_step"]["peak_held_bytes"])


def test_jax_gspmd_data_collectives_beside_the_ports(ranks, jax_compile):
    """GSPMD's (2, 2) train step of the smoke llama against the port's
    (rank 0's counted step).  Both gather the FSDP blocks over "data"
    before use.  The port packs a layer's blocks into one gather (and the
    embedding, the final norm and the tied head's embedding one each) and
    reduce-scatters their gradients the same way; GSPMD gathers each
    weight (and piece of one) on its own, 45 gathers, and sums the
    gradients over "data" with all-reduces, no reduce-scatter, beside
    two all-to-alls and a collective-permute of activations."""
    out, err = jax_compile.communicate(timeout=300)
    assert jax_compile.returncode == 0, err[-3000:]
    jax_c = json.loads(out.strip().splitlines()[-1])
    port = ranks[1][0]["train"]["llama3.2-1b"]["collectives"]
    n_layers = _cfg("llama3.2-1b").n_layers
    assert set(jax_c) >= {"all-gather", "all-reduce"}
    assert set(port) == {"all-gather", "all-reduce", "reduce-scatter"}
    # the port: the embedding, the final norm and the head's embedding,
    # then each layer once in the forward and once in its recompute, and
    # one logits gather over "model"
    assert port["all-gather"]["count"] == 3 + 2 * n_layers + 1
    assert port["reduce-scatter"]["count"] == 3 + n_layers
    assert jax_c["all-gather"]["count"] == PINNED_JAX_GATHERS
    assert jax_c.get("reduce-scatter", {}).get("count", 0.0) == (
        PINNED_JAX_SCATTERS)


# GSPMD's counts in the step above (jax 0.9 on the CPU)
PINNED_JAX_GATHERS = 45.0
PINNED_JAX_SCATTERS = 0.0


# ------------------------------------------------------------- serving
def _rows(out):
    return slice(*out["rows"])


@pytest.mark.parametrize("arch", SR.ARCHS)
def test_rank_rows_logits_match_jax(ranks, arch):
    want, got = ranks
    for r, out in enumerate(got):
        mine = out["serve"][arch]
        assert _rows(mine) == slice(coords(MESH, r)["data"] * 2,
                                    coords(MESH, r)["data"] * 2 + 2)
        ref = want["serve"][arch]["logits"][:, _rows(mine)]
        assert mine["logits"].shape == ref.shape
        np.testing.assert_allclose(mine["logits"], ref, **TOL)


@pytest.mark.parametrize("arch", SR.ARCHS + K.ARCHS)
def test_model_ranks_of_a_data_pair_bitwise_equal(ranks, arch):
    """The two "model" ranks of each "data" coordinate hold the same
    rows, whose logits come out gathered whole on both: the same bits."""
    _, got = ranks
    keys = ("logits",) if arch in SR.ARCHS else ("split", "kept")
    for d in range(2):
        a, b = (got[2 * d + m]["serve"][arch] for m in range(2))
        for k in keys:
            assert np.isfinite(a[k]).all()
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", K.ARCHS)
def test_kvseq_rows_match_jax(ranks, arch):
    """One row a "data" rank, its cache split by positions over "model"
    (a cache of 16: stretches of 8) or kept whole (35); internvl2-1b at
    3/1 heads (``_data_rank.KVSEQ_HEADS``)."""
    want, got = ranks
    for r, out in enumerate(got):
        mine = out["serve"][arch]
        assert mine["stretch"] == (coords(MESH, r)["model"] * 8, 8)
        for k in ("split", "kept"):
            ref = want["serve"][arch][k][:, _rows(mine)]
            np.testing.assert_allclose(mine[k], ref, **TOL)


@pytest.mark.parametrize("arch", DR.ONE_ROW)
def test_batch_of_one_replicated_over_data(ranks, arch):
    """A batch of 1 does not split over "data": every rank serves the
    row, and every rank's logits are the JAX package's row and the same
    bits on the four ranks."""
    want, got = ranks
    ref = (want["serve"][arch]["logits"] if arch in SR.ARCHS
           else want["serve"][arch]["split"])[:, :1]
    first = got[0]["serve"][arch]["one_row"]
    np.testing.assert_allclose(first, ref, **TOL)
    for r in got[1:]:
        np.testing.assert_array_equal(r["serve"][arch]["one_row"], first)


def test_serve_2d_prefill_from_fsdp_blocks(ranks):
    """dbrx-132b sets ``serve_2d_weights``: its prefill resolver is
    FSDP's, so each rank holds blocks split over "data" too, gathered
    a layer at a time; the logits equal the JAX package's rows."""
    want, got = ranks
    for out in got:
        pre = out["serve"]["fsdp_prefill"]
        assert pre["fsdp"], "no block split over 'data'"
        ref = want["serve"][DR.FSDP_PREFILL]["logits"][0][_rows(pre)]
        np.testing.assert_allclose(pre["logits"], ref, **TOL)


def test_the_decode_resolver_splits_nothing_over_data():
    """Serving's decode keeps tensor-parallel weights: no block of the
    (2, 2) decode run is split over "data"."""
    from repro_torch.models import transformer as T
    cfg = SR.with_heads(get_smoke("llama3.2-1b"))
    res = sharded_run(cfg, MESH, rank=3)
    assert not any("data" in ax for ax in T.split_axes(cfg, res).values())
    assert res.rows(4) == slice(2, 4) and res.rows(1) == slice(0, 1)
