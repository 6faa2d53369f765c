"""Sharded training on the ("data", "model") = (1, 4) mesh against the JAX
package, on the CPU: four ``gloo`` ranks (``parallel/spmd.py``), each
holding its block of the weights, running ``make_train_step(res=...)``,
whose collectives carry the gradients back.

* Twelve cases on one spawned rank set: the ten smoke configs
  (llama3.2-1b with its tied head, qwen3-32b with q/k norms, yi-9b,
  stablelm-3b at 4/4 heads, dbrx-132b with experts over ranks,
  falcon-mamba-7b over ``d_inner``, jamba-v0.1-52b at two microbatches,
  musicgen-large with codebooks, deepseek-v2-lite-16b with MLA split by
  heads and a shared expert, internvl2-1b at 14/2 heads, whole on every
  rank, with patches; GQA at 8/4 heads), falcon-mamba-7b with int8
  compression and llama3.2-1b with a clip norm below its gradients'
  norm.  Every norm weight is seeded.  Each is held against the JAX
  package's unsharded ``jax.value_and_grad(make_loss_fn(cfg))`` and
  ``make_train_step`` on the same numpy weights and tokens, at the
  tolerances of ``tests/test_torch_train_dense.py``: the loss at rtol
  1e-5, each gradient made whole (``convert.whole_from_ranks``) within
  1e-4 of its largest, ``grad_norm`` at rtol 1e-4, one AdamW step at
  ``STEP_TOL`` but for ``FLIPS``.
* The parameters whole on every rank, and their gradients, are bitwise
  equal on the four ranks after the step; the ranks import neither
  ``jax`` nor ``repro``.
* The planner's rank-0 train step on ``meta`` (``launch.dryrun.plan``
  on (1, 4)) predicts the collectives the ranks count in the step,
  kind by kind, for the smoke llama, jamba and dbrx cells; every
  config's ``h100x4`` train record at full width has its step, none
  refused.
* The JAX package's train steps of the dense and Mamba smoke cells,
  compiled on a forced 4-device host mesh (a subprocess, beside the
  ranks), run the port's all-reduces in count (dense) and bytes (Mamba's
  activations); the differences are pinned below.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_rank as SR
import _sharded_train_rank as R
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import step as JS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import card_mesh, make_test_mesh
from repro_torch.models import transformer as T
from repro_torch.models.convert import named_from_jax, whole_from_ranks
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel import spmd
from repro_torch.parallel.collectives import sharded_run
from repro_torch.parallel.sharding import Mesh
from test_torch_dense_configs import _seeded_norms
from test_torch_train_families import _assert_updates_close

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
IDS = [c[0] for c in R.CASES]
MESH = make_test_mesh(R.WORLD)
# one spawned rank set runs every case
RANKS_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg):
    """Numpy tokens (B, L), or (B, L, CB), and for ``vit_stub`` patches."""
    rng = np.random.default_rng(11)
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (R.B, R.L) + cb).astype(np.int32)}
    if cfg.frontend == "vit_stub":
        out["patches"] = rng.standard_normal(
            (R.B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax_case(case, jparams, batch):
    """The JAX package's unsharded loss, gradients and one train step."""
    _, _, _, step_kw, opt_kw = case
    jcfg = R.case_config(jax_get_smoke, case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, jparams)
    (total, m), grads = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True))(jp, jb)
    jopt = JA.OptConfig(**R.OPT, **opt_kw)
    state, sm = jax.jit(JS.make_train_step(jcfg, jopt, **step_kw))(
        JA.init_state(jp, jopt), jb)
    return dict(total=float(total), loss=float(m["loss"]),
                aux=float(m["aux"]), grads=_np_tree(grads),
                params=_np_tree(state.params),
                metrics={k: float(v) for k, v in sm.items()})


# the JAX package's train steps of the smoke llama (8/4 heads) and falcon
# cells at B = 4, S = 32, compiled on a forced 4-device host mesh with
# the resolver the JAX dry run trains with (FSDP; "data" is 1)
JAX_TRAIN_COLLECTIVES = """
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

mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
res = ShardingResolver(mesh, fsdp=True)


def is_ax(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree(axes, abst, param):
    return jax.tree.map(lambda ax, l: res.sharding(ax, l.shape, param=param),
                        axes, abst, is_leaf=is_ax)


out = {}
for arch in ("llama3.2-1b", "falcon-mamba-7b"):
    cfg = get_smoke(arch)
    if cfg.attn_kind == "gqa" and cfg.n_kv_heads != cfg.n_heads:
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    opt = OptConfig()
    st, st_ax = SP.abstract_train_state(cfg, opt)
    shape = ShapeConfig("t", %d, %d, "train")
    ins = SP.input_specs(cfg, shape)
    fn = jax.jit(STEP.make_train_step(cfg, opt, res=res),
                 in_shardings=(tree(st_ax, st, True),
                               tree(SP.batch_logical_axes(cfg, shape), ins,
                                    False)))
    with mesh:
        out[arch] = hlo_cost.analyze(
            fn.lower(st, ins).compile().as_text())["collectives"]
print(json.dumps(out))
""" % (R.L, R.B)


@pytest.fixture(scope="module")
def jax_compile():
    """The subprocess that compiles the JAX train steps, started before
    the ranks so that the two run together."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_TRAIN_COLLECTIVES],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def trained(tmp_path_factory, jax_compile):
    """By case id the JAX package's results; and the four ranks'."""
    case_dir = tmp_path_factory.mktemp("sharded_train")
    want = {}
    for case in R.CASES:
        jcfg = R.case_config(jax_get_smoke, case)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jparams = _seeded_norms(_np_tree(jparams), np.random.default_rng(3))
        batch = _batch(jcfg)
        np.savez(case_dir / f"{case[0]}.npz", **SR.flatten(jparams),
                 **{f"__{k}__": v for k, v in batch.items()})
        want[case[0]] = _jax_case(case, jparams, batch)
    ranks = spmd.run(R.train_cases, R.WORLD, store_dir=str(case_dir),
                     backend="gloo", device="cpu", args=(str(case_dir),),
                     timeout=RANKS_TIMEOUT_S)
    return want, ranks


def _cfg(cid):
    return R.case_config(get_smoke, next(c for c in R.CASES if c[0] == cid))


def _whole(cid, ranks, key):
    return whole_from_ranks(_cfg(cid), MESH, [
        {k: torch.from_numpy(v) for k, v in r[cid][key].items()}
        for r in ranks])


@pytest.mark.parametrize("cid", IDS)
def test_loss_matches_jax(trained, cid):
    want, ranks = trained
    for r in ranks:
        for k in ("total", "loss", "aux"):
            np.testing.assert_allclose(r[cid][k], want[cid][k], rtol=1e-5,
                                       atol=1e-7 if k == "aux" else 0)
    assert (want[cid]["aux"] > 0) == bool(_cfg(cid).moe.n_routed)


@pytest.mark.parametrize("cid", IDS)
def test_gradients_made_whole_match_jax(trained, cid):
    want, ranks = trained
    got = _whole(cid, ranks, "grads")
    ref = named_from_jax(_cfg(cid), want[cid]["grads"], device="cpu")
    assert got.keys() == ref.keys()
    for n, w in ref.items():
        top = float(w.abs().max())
        assert top > 0, n
        assert float((got[n] - w).abs().max()) <= 1e-4 * top, n


@pytest.mark.parametrize("cid", IDS)
def test_train_step_matches_jax(trained, cid):
    want, ranks = trained
    wm = want[cid]["metrics"]
    for r in ranks:
        m = r[cid]["metrics"]
        np.testing.assert_allclose(m["loss"], wm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], wm["grad_norm"],
                                   rtol=1e-4)
    cfg = _cfg(cid)
    opt = OptConfig(**R.OPT, **next(c for c in R.CASES if c[0] == cid)[4])
    if cid.endswith("clipped"):
        assert wm["grad_norm"] > 10 * opt.clip_norm
    _assert_updates_close(_whole(cid, ranks, "params"),
                          named_from_jax(cfg, want[cid]["params"],
                                         device="cpu"), opt.lr)


@pytest.mark.parametrize("cid", IDS)
def test_whole_parameters_stay_bitwise_equal_on_every_rank(trained, cid):
    """A parameter that no rank splits (norms, the router, MLA's
    ``wkv_a``, internvl2-1b's attention), its gradient and its updated
    value are the same bits on the four ranks; the split ones are a
    quarter of their whole."""
    _, ranks = trained
    first = ranks[0][cid]
    whole = dict(T.init_abstract(_cfg(cid)).named_parameters())
    assert first["split"] and len(first["split"]) < len(whole)
    for name, p in whole.items():
        if name in first["split"]:
            assert first["params"][name].size * R.WORLD == p.numel(), name
            continue
        for r in ranks[1:]:
            for key in ("grads", "params"):
                np.testing.assert_array_equal(r[cid][key][name],
                                              first[key][name], err_msg=name)


def test_ranks_import_neither_jax_nor_repro(trained):
    for r in trained[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


@pytest.mark.parametrize("cid", R.PLANNED)
def test_plan_predicts_the_ranks_train_collectives(trained, cid):
    """``plan`` on (1, 4) runs rank 0's train step on ``meta`` under the
    fake backend: the forward's, the backward's and the recompute's
    collectives and the norm's all-reduce equal those rank 0 counted in
    the real four-rank step of the same cell, kind by kind."""
    cfg = _cfg(cid)
    rec = D.plan(cfg, ShapeConfig("t", R.L, R.B, "train"), MESH)
    got = trained[1][0][cid]["collectives"]
    assert got["all-reduce"]["count"] > 0 and got["all-gather"]
    assert rec["collectives"] == got == rec["sharded_step"]["collectives"]
    assert rec["collective_wire_bytes_per_device"] == sum(
        c["wire_bytes"] for c in got.values())
    assert rec["sharded_step"]["predicted_peak_bytes"] == (
        rec["argument_bytes_per_device"]
        + rec["sharded_step"]["peak_held_bytes"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_h100x4_train_record_has_rank_0s_step(arch):
    """Each config's train cell on ``h100x4``, at full width (its first
    block of layers, one microbatch of 512 tokens), plans rank 0's step:
    none is refused (deepseek-v2-lite-16b and internvl2-1b, which are
    not served sharded, train sharded), and each split config runs
    collectives."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, accum_override=0,
                              n_layers=full.block_period
                              + full.moe.first_dense)
    shape = ShapeConfig("t", 512, 1, "train")
    assert (arch, "train_4k") in D.cell_list()
    rec = D.plan(cfg, shape, card_mesh("h100x4"))
    step = rec["sharded_step"]
    assert "refused" not in step, step.get("refused")
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["collective_wire_bytes_per_device"] > 0
    assert step["flops"] < rec["flops"]


@pytest.mark.parametrize("mesh, heads", [
    (Mesh(("pod", "data", "model"), (2, 1, 2)), {}),
    (MESH, dict(n_heads=8, n_kv_heads=2)),
])
def test_check_trainable_refuses(mesh, heads):
    """A mesh with a "pod" axis above 1 (a "data" axis above 1 is taken:
    ``tests/test_torch_sharded_data.py``), and query heads that split
    over the ranks where the kv heads do not."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), **heads)
    with pytest.raises(ValueError):
        sharded_run(cfg, mesh, train=True)


def test_deepseek_trains_sharded_though_not_served_sharded():
    """Served sharded too since its cache split by positions is served
    (``tests/test_torch_sharded_kvseq.py``): both runs take the mesh,
    and only serving has a cache to split."""
    cfg = get_smoke("deepseek-v2-lite-16b")
    assert sharded_run(cfg, MESH).kv_stretch(
        ("batch", "kv_seq", "kv_lora"), (1, 16, 32)) == (0, 4)
    assert sharded_run(cfg, MESH, train=True).size == R.WORLD


def test_jax_train_collectives_beside_the_ports(trained, jax_compile):
    """GSPMD's train steps of the dense and Mamba smoke cells against the
    port's (rank 0's counted step).  Dense: 13 all-reduces each; GSPMD's
    carry 18 activations of 32,768 bytes, for it sums the input gradient
    of each split projection (q, k, v; gate, up) on its own where the
    port's entry identity sums them once (12 and a 4-byte norm), and it
    gathers the vocab-split head's weight (65,536 bytes) where the port
    gathers the logits (131,072).  Mamba: the same 258,048 bytes of
    activations all-reduced; GSPMD's 17 all-reduces carry 44 bytes of
    norm pieces (the port sums its blocks' squares into one 4-byte
    all-reduce) and its fused ``in_proj`` moves by collective-permutes,
    which the port's half-by-half split needs not."""
    out, err = jax_compile.communicate(timeout=300)
    assert jax_compile.returncode == 0, err[-3000:]
    jax_c = json.loads(out.strip().splitlines()[-1])
    port = {a: trained[1][0][a]["collectives"]
            for a in ("llama3.2-1b", "falcon-mamba-7b")}
    act = 32768.0
    assert jax_c["llama3.2-1b"] == {
        "all-reduce": {"count": 13.0, "result_bytes": 18 * act + 32,
                       "wire_bytes": 1.5 * (18 * act + 32)},
        "all-gather": {"count": 1.0, "result_bytes": 65536.0,
                       "wire_bytes": 49152.0}}
    assert port["llama3.2-1b"] == {
        "all-reduce": {"count": 13.0, "result_bytes": 12 * act + 4,
                       "wire_bytes": 1.5 * (12 * act + 4)},
        "all-gather": {"count": 1.0, "result_bytes": 131072.0,
                       "wire_bytes": 98304.0}}
    jf, pf = jax_c["falcon-mamba-7b"], port["falcon-mamba-7b"]
    assert set(jf) == {"all-reduce", "all-gather", "collective-permute"}
    assert set(pf) == {"all-reduce", "all-gather"}
    assert (jf["all-reduce"]["count"], pf["all-reduce"]["count"]) == (17, 13)
    assert jf["all-reduce"]["result_bytes"] - 44 == 258048.0 == (
        pf["all-reduce"]["result_bytes"] - 4)
    assert jf["collective-permute"]["count"] > 0
