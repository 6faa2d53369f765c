"""A "pod" axis above 1 against the JAX package, on the CPU: four
``gloo`` ranks on the ("pod", "data", "model") = (2, 1, 2) mesh, the
card meshes' ``h100x2x1x2`` (the JAX package's multi-pod axes, 2x16x16,
at one card a rank), one spawned rank set for every case
(``tests/_seq_rank.py``).

* Training (the FSDP resolver, whose "data" is 1: every weight whole
  over "pod"): llama3.2-1b and deepseek-v2-lite-16b with a batch of 4,
  whose rows the resolver splits over ("pod", "data"), and a batch of 1,
  which it replicates over "pod" (the rows counted once, not once a pod).
  The loss, every gradient made whole (``convert.whole_from_ranks`` on
  the pod mesh) and one AdamW step against the JAX package's unsharded
  ones, at rtol = atol = 2e-4.
* Serving: llama3.2-1b's prefill and teacher-forced decode steps, each
  "pod" rank's rows of the logits against the JAX package's.
* The planner's rank-0 train step on ``h100x2x1x2`` is not refused, and
  its collectives equal those rank 0 counted in the four-rank step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _seq_rank as Q
import _sharded_rank as SR
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.training import step as JSTEP
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import card_mesh
from repro_torch.parallel import spmd
from test_torch_sharded_seq import TOL, case_of, check_case, save_cases

MESH = card_mesh("h100x2x1x2")
IDS = [c[0] for c in Q.POD_CASES]
RANKS_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _serve_want(case_dir):
    jcfg = dataclasses.replace(jax_get_smoke(Q.SERVE_ARCH), **Q.GQA)
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0))[0])
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size,
        (Q.SERVE_B, Q.SERVE_P + Q.SERVE_STEPS)).astype(np.int32)
    np.savez(case_dir / "serve.npz", __tokens__=tokens, **SR.flatten(jparams))
    cache, _ = JT.init_cache(jcfg, Q.SERVE_B, Q.SERVE_P + Q.SERVE_STEPS)
    lg, cache = jax.jit(JSTEP.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :Q.SERVE_P])}, cache)
    outs = [lg]
    step = jax.jit(JSTEP.make_decode_step(jcfg))
    for i in range(Q.SERVE_P, Q.SERVE_P + Q.SERVE_STEPS):
        lg, cache = step(jparams, jnp.asarray(tokens[:, i:i + 1]), cache,
                         jnp.int32(i))
        outs.append(lg)
    return np.stack([np.asarray(o) for o in outs])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("sharded_pod")
    want = save_cases(case_dir, Q.POD_CASES)
    want["serve"] = _serve_want(case_dir)
    got = spmd.run(Q.pod_cases, Q.WORLD, store_dir=str(case_dir),
                   backend="gloo", device="cpu", args=(str(case_dir),),
                   timeout=RANKS_TIMEOUT_S)
    return want, got


@pytest.mark.parametrize("cid", IDS)
def test_train_matches_jax(ranks, cid):
    check_case(*ranks, case_of(cid, Q.POD_CASES), MESH)


@pytest.mark.parametrize("cid", IDS)
def test_rows_split_over_pod_or_replicated(ranks, cid):
    """A batch of 4 gives each "pod" rank 2 rows and sums over "pod"; a
    batch of 1 is every rank's, summed over nothing; the loss and norm
    are the same bits on the four ranks."""
    rows = case_of(cid, Q.POD_CASES)[4]
    _, got = ranks
    for r, out in enumerate(got):
        mine = out["train"][cid]
        pod = r // 2
        if rows == 4:
            assert (mine["rows"], mine["axes"]) == ((2 * pod, 2 * pod + 2),
                                                    ("pod",))
        else:
            assert (mine["rows"], mine["axes"]) == ((0, 1), ())
        assert mine["stretch"] is None
        assert mine["metrics"] == got[0]["train"][cid]["metrics"]


def test_served_rows_match_jax(ranks):
    want, got = ranks
    for r, out in enumerate(got):
        pod = r // 2
        mine = out["serve"]
        assert mine["rows"] == (2 * pod, 2 * pod + 2)
        np.testing.assert_allclose(
            mine["logits"], want["serve"][:, 2 * pod:2 * pod + 2], **TOL)


def test_ranks_import_neither_jax_nor_repro(ranks):
    for r in ranks[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


@pytest.mark.parametrize("cid", ["llama3.2-1b-rows", "llama3.2-1b-one"])
def test_plan_predicts_the_ranks_train_collectives(ranks, cid):
    """``plan`` on ``h100x2x1x2`` runs rank 0's train step on ``meta``
    under the fake backend with its "model" and "pod" groups: its
    all-reduces and gathers equal those rank 0 counted in the real
    four-rank step (the rows' sums over "pod" where the batch splits
    over it, none where it is replicated)."""
    case = case_of(cid, Q.POD_CASES)
    cfg = Q.case_config(get_smoke, case)
    rec = D.plan(cfg, ShapeConfig("t", Q.L, case[4], "train"), MESH)
    step = rec["sharded_step"]
    assert "refused" not in step, step.get("refused")
    got = ranks[1][0]["train"][cid]["collectives"]
    assert rec["collectives"] == got == step["collectives"]
    assert "reduce-scatter" not in got    # "data" is 1: nothing FSDP-split


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_pod_specs_equal_reference(arch):
    """On ("pod", "data", "model") = (2, 1, 2) every parameter's spec
    (without and with FSDP, which takes the size-1 "data" and so splits
    nothing over "pod") and the activations' specs at a batch of 4 and
    of 1 are the JAX ``ShardingResolver``'s, exactly."""
    from repro.parallel.sharding import ShardingResolver as JResolver
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import ShardingResolver
    from test_torch_sharding import (jax_leaves, jax_mesh, jax_params,
                                     port_names, port_params)
    cfg = get_config(arch)
    jm = jax_mesh(MESH)
    params, axes = port_params(arch)
    shapes = dict((n, p.shape) for n, p in params.named_parameters())
    for fsdp in (False, True):
        jr, r = JResolver(jm, fsdp=fsdp), ShardingResolver(MESH, fsdp=fsdp)
        for path, leaf, ax in jax_leaves(*jax_params(arch)):
            want = tuple(jr.spec(ax, leaf.shape, param=True))
            names, stacked = port_names(cfg, path)
            want = want[1:] if stacked else want
            for n in names:
                shape = T.logical_shape(cfg, axes[n], shapes[n])
                got = r.spec(axes[n], shape, param=True)
                assert got == want, (n, fsdp)
                assert not any("pod" in ((a,) if isinstance(a, str) else a)
                               for a in got if a is not None), n
        for rows in (4, 1):
            for logical, shape in (
                    (("batch", "seq"), (rows, 32)),
                    (("batch", "seq", "heads", None), (rows, 32, 32, 64)),
                    (("batch", "seq", "d_ff"), (rows, 32, 8192)),
                    (("experts", "capacity", None), (64, rows * 32, 2048))):
                assert r.spec(logical, shape) == tuple(
                    jr.spec(logical, shape)), (logical, rows)

