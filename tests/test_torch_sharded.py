"""Sharded serving on the ("data", "model") = (1, 4) mesh against the JAX
package, on the CPU: four ``gloo`` ranks (``parallel/spmd.py``, a file
store under ``tmp_path``), each holding its block of the weights and
caches and joining the partial sums with explicit collectives.

* Eight smoke configs (llama3.2-1b with its tied head, qwen3-32b with q/k
  norms, yi-9b, stablelm-3b with its 4 kv heads (MHA), dbrx-132b with
  experts over ranks, falcon-mamba-7b over ``d_inner``, jamba-v0.1-52b
  with attention, Mamba and MoE, and musicgen-large with codebooks; GQA
  at 8/4 heads on both sides) run on
  one spawned set of ranks: the prefill's and three teacher-forced
  decode steps' logits of every rank equal the JAX package's unsharded
  ``make_prefill_step``/``make_decode_step`` at rtol = atol = 2e-4, are
  bitwise equal on the four ranks, and MoE routing equals the
  one-process port's.  The ranks load the JAX parameters from ``.npz``
  and import neither ``jax`` nor ``repro``.
* The dense cell's collectives, counted by ``OpCost`` on rank 0, equal
  the JAX package's (a subprocess compiles the same cell on a forced
  4-device host mesh and reads ``hlo_cost.analyze``), with the port's
  one gather of the logits beside them; the Mamba cell's all-reduces
  equal GSPMD's too.
* The planner's ``h100x4``-style record of the smoke jamba and dbrx
  cells predicts rank 0's counted collectives kind by kind.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_rank as R
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.training import step as JSTEP
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import spmd

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = dict(rtol=2e-4, atol=2e-4)
MOE = ["dbrx-132b", "jamba-v0.1-52b"]
# one spawned rank set runs all six configs
RANKS_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tokens(cfg):
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (R.B, R.P + R.STEPS) + cb).astype(np.int32)


def _jax_logits(jcfg, jparams, tokens):
    """The JAX package's unsharded steps, teacher-forced as the ranks."""
    jparams = jax.tree.map(jnp.asarray, jparams)
    cache, _ = JT.init_cache(jcfg, R.B, R.P + R.STEPS)
    lg, cache = jax.jit(JSTEP.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :R.P])}, cache)
    outs = [lg]
    step = jax.jit(JSTEP.make_decode_step(jcfg))
    for i in range(R.P, R.P + R.STEPS):
        lg, cache = step(jparams, jnp.asarray(tokens[:, i:i + 1]), cache,
                         jnp.int32(i))
        outs.append(lg)
    return np.stack([np.asarray(o) for o in outs])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per arch: the JAX logits, the one-process port's routes, and the
    four ranks' results."""
    case_dir = tmp_path_factory.mktemp("sharded")
    want = {}
    for arch in R.ARCHS:
        cfg, jcfg = R.with_heads(get_smoke(arch)), R.with_heads(
            jax_get_smoke(arch))
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jparams = jax.tree.map(np.asarray, jparams)
        tokens = _tokens(cfg)
        np.savez(case_dir / f"{arch}.npz", __tokens__=tokens,
                 **R.flatten(jparams))
        one = params_from_jax(cfg, jparams, device="cpu")
        _, _, routes = R.teacher_forced(cfg, one, tokens)
        want[arch] = dict(logits=_jax_logits(jcfg, jparams, tokens),
                          routes=routes, param_bytes=sum(
                              p.numel() * p.element_size()
                              for p in one.parameters()))
    ranks = spmd.run(R.serve_cases, R.WORLD, store_dir=str(case_dir),
                     backend="gloo", device="cpu",
                     args=(str(case_dir), R.ARCHS),
                     timeout=RANKS_TIMEOUT_S)
    return want, ranks


@pytest.mark.parametrize("arch", R.ARCHS)
def test_sharded_logits_match_jax(served, arch):
    want, ranks = served
    for r in ranks:
        got = r[arch]["logits"]
        assert got.shape == want[arch]["logits"].shape
        np.testing.assert_allclose(got, want[arch]["logits"], **TOL)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_gathered_logits_bitwise_equal_on_every_rank(served, arch):
    _, ranks = served
    first = ranks[0][arch]["logits"]
    assert np.isfinite(first).all()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[arch]["logits"], first)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_each_rank_holds_a_quarter_of_the_split_weights(served, arch):
    """The ranks' weights add up to the whole model's and the replicated
    ones (norms, router) are a small part: no rank holds the model."""
    want, ranks = served
    total = want[arch]["param_bytes"]
    held = [r[arch]["param_bytes"] for r in ranks]
    assert len(set(held)) == 1
    assert total / 4 <= held[0] < total / 3


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equals_one_process_run(served, arch):
    want, ranks = served
    routes = want[arch]["routes"]
    assert routes
    for r in ranks:
        assert len(r[arch]["routes"]) == len(routes)
        for got, ref in zip(r[arch]["routes"], routes):
            np.testing.assert_array_equal(got, ref)


def test_ranks_import_neither_jax_nor_repro(served):
    for r in served[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


# the JAX package's collectives of four smoke cells, compiled on a forced
# 4-device host mesh (the dense and Mamba cells are held to them below;
# GSPMD moves the MoE and Mamba layers' data with collective-permutes and
# all-gathers that the port's explicit split does without: PERF.md)
JAX_ARCHS = ["llama3.2-1b", "dbrx-132b", "jamba-v0.1-52b",
             "falcon-mamba-7b"]
JAX_COLLECTIVES = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch import hlo_cost
from repro.launch import specs as SP
from repro.parallel.sharding import ShardingResolver
from repro.training import step as STEP

# Auto axes: jax.make_mesh's Explicit ones make constrain raise
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
B, S = {B}, {S}
res = ShardingResolver(mesh)


def is_ax(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree(axes, abst, param):
    return jax.tree.map(lambda ax, l: res.sharding(ax, l.shape, param=param),
                        axes, abst, is_leaf=is_ax)


out = {{}}
for arch in {archs!r}:
    cfg = get_smoke(arch)
    if cfg.attn_kind == "gqa" and cfg.n_kv_heads != cfg.n_heads:
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    params, p_axes = SP.abstract_params(cfg)
    cache, c_axes = SP.abstract_cache(cfg, B, S)
    p_sh, c_sh = tree(p_axes, params, True), tree(c_axes, cache, False)
    pshape = ShapeConfig("p", S, B, "prefill")
    ins = SP.input_specs(cfg, pshape)
    b_sh = tree(SP.batch_logical_axes(cfg, pshape), ins, False)
    dins = SP.input_specs(cfg, ShapeConfig("d", S, B, "decode"))
    t_sh = NamedSharding(mesh, P())
    with mesh:
        pre = jax.jit(STEP.make_prefill_step(cfg, res=res),
                      in_shardings=(p_sh, b_sh, c_sh),
                      out_shardings=(None, c_sh)).lower(params, ins, cache)
        dec = jax.jit(STEP.make_decode_step(cfg, res=res),
                      in_shardings=(p_sh, t_sh, c_sh, t_sh),
                      out_shardings=(None, c_sh)).lower(
            params, dins["token"], cache, dins["pos"])
    out[arch] = {{k: hlo_cost.analyze(c.compile().as_text())["collectives"]
                 for k, c in (("prefill", pre), ("decode", dec))}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_collectives():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         JAX_COLLECTIVES.format(B=R.B, S=R.P, archs=JAX_ARCHS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _logits_gather(arch):
    cfg = R.with_heads(get_smoke(arch))
    nbytes = float(R.B * cfg.vocab_size * 4)
    return {"count": 1.0, "result_bytes": nbytes, "wire_bytes": 0.75 * nbytes}


def test_dense_cell_collectives_equal_jax(served, jax_collectives):
    """The smoke llama at 8/4 heads, B=4, S=32: 5 all-reduces (2 a layer,
    1 for the vocab-split embedding) of 163,840 result bytes at prefill
    (245,760 on the wire) and 5,120 at decode, as GSPMD's; the port's one
    gather of the logits is its only other collective."""
    jax_c = jax_collectives["llama3.2-1b"]
    port = served[1][0]["llama3.2-1b"]
    assert jax_c["prefill"] == {"all-reduce": {
        "count": 5.0, "result_bytes": 163840.0, "wire_bytes": 245760.0}}
    assert jax_c["decode"]["all-reduce"]["result_bytes"] == 5120.0
    for kind in ("prefill", "decode"):
        assert set(port[kind]) == {"all-reduce", "all-gather"}
        assert port[kind]["all-reduce"] == jax_c[kind]["all-reduce"]
        assert port[kind]["all-gather"] == _logits_gather("llama3.2-1b")


def test_mamba_cell_all_reduces_equal_jax(served, jax_collectives):
    """The smoke falcon-mamba-7b: the port's all-reduces (the embedding,
    each layer's ``x_proj`` and ``out_proj``) are GSPMD's, count and
    bytes; GSPMD also moves the fused ``in_proj``'s halves with
    collective-permutes, which the port's half-by-half split needs not."""
    jax_c = jax_collectives["falcon-mamba-7b"]
    port = served[1][0]["falcon-mamba-7b"]
    for kind in ("prefill", "decode"):
        assert port[kind]["all-reduce"] == jax_c[kind]["all-reduce"]
        assert jax_c[kind]["collective-permute"]["count"] > 0
        assert set(port[kind]) == {"all-reduce", "all-gather"}
        assert port[kind]["all-gather"] == _logits_gather("falcon-mamba-7b")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE)
def test_plan_predicts_the_ranks_collectives(served, arch, kind):
    """``plan`` on the (1, 4) mesh runs rank 0's step on ``meta`` under
    the fake backend: its collectives equal those rank 0 counted in the
    real four-rank run of the same cell, kind by kind."""
    cfg = R.with_heads(get_smoke(arch))
    rec = D.plan(cfg, ShapeConfig(kind, R.P, R.B, kind), make_test_mesh(4))
    got = served[1][0][arch][kind]
    assert got and rec["collectives"] == got
    assert rec["sharded_step"]["collectives"] == got
    assert rec["collective_wire_bytes_per_device"] == sum(
        c["wire_bytes"] for c in got.values())
