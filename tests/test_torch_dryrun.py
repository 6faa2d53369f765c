"""The port's planner (``repro_torch.launch.dryrun``, ``launch/specs.py``,
``launch/op_cost.py``) against the JAX package's dry run, on the CPU.

* Per-device argument bytes of every arch x shape cell on the 16x16,
  2x16x16, (1, 1) and (1, 4) meshes equal the sum of
  ``NamedSharding.shard_shape`` bytes over the JAX package's
  ``launch/specs.py`` state, exactly (no compile needed).
* A subprocess lowers and compiles the smoke llama's train step on a
  (4, 2) mesh of 8 CPU devices (built with ``Mesh``, as the JAX
  package's own dry run cannot under jax 0.9): its ``memory_analysis()``
  argument bytes equal the port's.
* ``op_cost``'s dot flops of a step run on the CPU (plain versions, the
  JAX package's math) against ``hlo_cost.analyze`` of the JAX step
  compiled on one CPU device, for the smoke llama, deepseek, falcon-mamba
  and jamba in train, prefill and decode: within ``DOT_FLOPS_RTOL``.
* The meta fakes of the kernels, the planner allocating no data, the CLI
  without ``jax`` or ``repro``, ``calibrate.bytes_per_wg_from_ops``."""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.launch import hlo_cost
from repro.launch import specs as JSP
from repro.optim.adamw import OptConfig as JOptConfig
from repro.parallel.sharding import ShardingResolver as JResolver
from repro.training import step as JSTEP
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import kernel as KA
from repro_torch.kernels.flash_decode import kernel as KD
from repro_torch.kernels.mamba_scan import kernel as KS
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import Mesh
from repro_torch.training import step as STEP

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x1": make_test_mesh(1), "1x4": make_test_mesh(4)}
CELLS = D.cell_list()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_mesh(mesh: Mesh) -> JMesh:
    devs = np.array(jax.devices()[:1] * mesh.size).reshape(mesh.shape)
    return JMesh(devs, mesh.axis_names)


def is_ax(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@functools.lru_cache(maxsize=None)
def jax_state(arch, shape_name):
    """[(abstract tree, its logical axes or a spec, param)] of the JAX
    dry run's step arguments (``launch/dryrun.py`` lower_cell)."""
    cfg, shape = jax_get_config(arch), SHAPES[shape_name]
    batch = (JSP.input_specs(cfg, shape), JSP.batch_logical_axes(cfg, shape),
             False)
    if shape.kind == "train":
        st, ax = JSP.abstract_train_state(cfg, JOptConfig())
        return [(st, ax, True), batch]
    params = (JSP.abstract_params_unstacked(cfg)
              if shape.kind == "decode" and cfg.decode_unroll
              else JSP.abstract_params(cfg))
    cache = JSP.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    out = [params + (True,), cache + (False,)]
    if shape.kind == "prefill":
        return out + [batch]
    ins = JSP.input_specs(cfg, shape)
    return out + [(ins, {k: P() for k in ins}, False)]


def jax_argument_bytes(arch, shape_name, mesh: Mesh) -> int:
    cfg, shape = jax_get_config(arch), SHAPES[shape_name]
    jm = jax_mesh(mesh)
    res = JResolver(jm, fsdp=shape.kind == "train" or (
        shape.kind == "prefill" and cfg.serve_2d_weights))
    total = 0
    for tree, axes, param in jax_state(arch, shape_name):
        leaves = jax.tree_util.tree_leaves(tree)
        specs = jax.tree_util.tree_leaves(
            axes, is_leaf=lambda x: is_ax(x) or isinstance(x, P))
        assert len(leaves) == len(specs)
        for leaf, ax in zip(leaves, specs):
            spec = ax if isinstance(ax, P) else res.spec(ax, leaf.shape,
                                                         param=param)
            shard = NamedSharding(jm, spec).shard_shape(leaf.shape)
            total += math.prod(shard) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_argument_bytes_equal_reference(arch, shape_name, mesh_name):
    mesh = MESHES[mesh_name]
    got = D.argument_bytes(get_config(arch), SHAPES[shape_name], mesh)
    assert sum(got.values()) == jax_argument_bytes(arch, shape_name, mesh)


SUBPROCESS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch import specs as SP
from repro.optim.adamw import OptConfig
from repro.parallel.sharding import ShardingResolver
from repro.training import step as STEP

assert len(jax.devices()) == 8
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
cfg = get_smoke("llama3.2-1b")
shape = ShapeConfig("t", 64, 8, "train", accum_steps=2)
resolver = ShardingResolver(mesh, fsdp=True)
opt = OptConfig()
state_abs, state_axes = SP.abstract_train_state(cfg, opt)
batch_abs = SP.input_specs(cfg, shape)
batch_axes = SP.batch_logical_axes(cfg, shape)


def is_ax(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


st_sh = jax.tree.map(lambda ax, l: resolver.sharding(ax, l.shape, param=True),
                     state_axes, state_abs, is_leaf=is_ax)
b_sh = jax.tree.map(lambda ax, l: resolver.sharding(ax, l.shape),
                    batch_axes, batch_abs, is_leaf=is_ax)
fn = STEP.make_train_step(cfg, opt, res=resolver, accum_steps=2)
jfn = jax.jit(fn, in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None),
              donate_argnums=(0,))
with mesh:
    compiled = jfn.lower(state_abs, batch_abs).compile()
mem = compiled.memory_analysis()
print(json.dumps({"argument_bytes": int(mem.argument_size_in_bytes)}))
"""


def test_small_mesh_argument_bytes_equal_compiled():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SUBPROCESS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])["argument_bytes"]
    got = D.argument_bytes(get_smoke("llama3.2-1b"),
                           ShapeConfig("t", 64, 8, "train", accum_steps=2),
                           Mesh(("data", "model"), (4, 2)))
    assert sum(got.values()) == want


# --------------------------------------------------- dot flops vs HLO
# op_cost's dot flops against hlo_cost's of the same step, on the smoke
# configs.  Without rematerialisation the products are the same on both
# sides, exactly.  With each config's remat policy (the configs' own),
# torch.utils.checkpoint recomputes each layer's whole forward in its
# backward, while XLA drops recomputed products whose results the
# backward never reads and the JAX package groups its remat scan in two
# levels: deepseek's step holds 3.8% more products in the port, jamba's
# 0.6% fewer; llama's and falcon-mamba's are equal.
DOT_FLOPS_RTOL = {"off": 1e-9, "config": 5e-2}
B, S, ACCUM = 4, 32, 2


def _shape(kind):
    return ShapeConfig(kind, S, B, kind, accum_steps=ACCUM if kind ==
                       "train" else 1)


def _cfgs(arch, remat):
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    if remat == "off":
        jcfg = dataclasses.replace(jcfg, remat_policy="everything")
        cfg = dataclasses.replace(cfg, remat_policy="everything")
    return jcfg, cfg


def jax_dot_flops(cfg, kind):
    shape = _shape(kind)
    if kind == "train":
        opt = JOptConfig()
        st, _ = JSP.abstract_train_state(cfg, opt)
        fn = JSTEP.make_train_step(cfg, opt, accum_steps=ACCUM)
        lowered = jax.jit(fn).lower(st, JSP.input_specs(cfg, shape))
    elif kind == "prefill":
        params, _ = JSP.abstract_params(cfg)
        cache, _ = JSP.abstract_cache(cfg, B, S)
        lowered = jax.jit(JSTEP.make_prefill_step(cfg)).lower(
            params, JSP.input_specs(cfg, shape), cache)
    else:
        params, _ = (JSP.abstract_params_unstacked(cfg) if cfg.decode_unroll
                     else JSP.abstract_params(cfg))
        cache, _ = JSP.abstract_cache(cfg, B, S)
        ins = JSP.input_specs(cfg, shape)
        lowered = jax.jit(JSTEP.make_decode_step(cfg)).lower(
            params, ins["token"], cache, ins["pos"])
    return hlo_cost.analyze(lowered.compile().as_text())["dot_flops"]


def port_cpu_cost(cfg, kind) -> op_cost.OpCost:
    """The step run on the CPU (plain versions) under OpCost."""
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    cb = (cfg.n_codebooks,) if cfg.frontend == "encodec_stub" else ()
    tokens = torch.randint(0, cfg.vocab_size, (B, S) + cb, generator=g,
                           dtype=torch.int32)
    if kind == "train":
        opt = OptConfig()
        state = adamw.init_state(params, opt)
        with op_cost.OpCost() as oc:
            STEP.make_train_step(cfg, opt, accum_steps=ACCUM)(
                state, {"tokens": tokens})
        return oc
    cache = T.init_cache(cfg, B, S, device="cpu")
    if kind == "decode":
        STEP.make_prefill_step(cfg)(params, {"tokens": tokens[:, :S - 1]},
                                    cache)
    with op_cost.OpCost() as oc:
        if kind == "prefill":
            STEP.make_prefill_step(cfg)(params, {"tokens": tokens}, cache)
        else:
            STEP.make_decode_step(cfg)(params, tokens[:, S - 1:], cache,
                                       S - 1)
    return oc


@pytest.mark.parametrize("arch,kind,remat", [
    (arch, kind, remat)
    for arch in ("llama3.2-1b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
                 "jamba-v0.1-52b")
    for kind, remat in (("train", "off"), ("train", "config"),
                        ("prefill", "config"), ("decode", "config"))])
def test_dot_flops_match_hlo_cost(arch, kind, remat):
    jcfg, cfg = _cfgs(arch, remat)
    got = port_cpu_cost(cfg, kind).dot_flops
    want = jax_dot_flops(jcfg, kind)
    assert got == pytest.approx(want, rel=DOT_FLOPS_RTOL[remat]), (got, want)


# ------------------------------------------------------------ op_cost
def test_matmul_costs_2mnk_and_its_bytes():
    a, b = torch.randn(16, 24), torch.randn(24, 40)
    with op_cost.OpCost() as oc:
        c = a @ b
    assert oc.dot_flops == oc.flops == 2 * 16 * 24 * 40
    assert oc.traffic_bytes == 4 * (16 * 24 + 24 * 40 + 16 * 40)
    assert oc.transcendentals == 0
    assert dict(oc.op_histogram()) == {"aten.mm": 1}
    x, y = torch.randn(3, 5, 1), torch.randn(3, 1, 7)
    with op_cost.OpCost() as oc:          # one term: an outer product
        torch.bmm(x, y)
    assert oc.dot_flops == 0 and oc.flops == 3 * 5 * 7
    with op_cost.OpCost() as oc:
        torch.exp(c).sum()
        c.view(-1).t()
    assert oc.transcendentals == 16 * 40 and oc.flops == 2 * 16 * 40
    assert oc.traffic_bytes == 4 * (2 * 16 * 40 + 16 * 40 + 1)
    assert oc.summary()["collectives"] == {} == op_cost.collective_stats()


def test_peak_counts_held_storages_rounded():
    x = torch.empty(1000, device="meta")
    with op_cost.OpCost() as oc:
        a = x * 2                       # 4000 bytes -> 4096
        b = a + 1
        del a
        c = b * 3                       # a freed: 2 held at most
        c.add_(1)                       # in place: nothing new
        v = c.view(10, 100)             # a view: nothing new
    assert oc.peak == 2 * 4096 and oc.held() == 2 * 4096
    del b, c, v
    assert oc.held() == 0


# ------------------------------------------------------ kernels on meta
def test_meta_fakes_give_the_kernels_shapes_and_tally():
    m = "meta"
    q = torch.empty(2, 100, 16, 192, dtype=torch.bfloat16, device=m)
    kv = torch.empty(2, 100, 4, 192, dtype=torch.bfloat16, device=m)
    counts = (KA.launches, KA.bwd_launches, KD.launches, KS.launches,
              KS.bwd_launches)
    before = {k: dict(v) for k, v in KA.meta_cost.items()}
    out, lse = KA.flash_attention_fwd(q, kv, kv, keep_lse=True)
    assert out.shape == q.shape and out.device.type == m
    assert lse.shape == (2, 16, 100) and lse.dtype == torch.float32
    dq, dk, dv = KA.flash_attention_bwd(q, kv, kv, out, out, lse)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, kv.shape, kv.shape)
    fwd = KA.meta_cost["flash_attention"]
    assert fwd["calls"] == before.get("flash_attention", {}).get(
        "calls", 0) + 1
    with op_cost.OpCost() as oc:
        KA.flash_attention(q, kv, kv)
    assert oc.kernels["flash_attention"]["flops"] == (
        4.0 * 2 * 16 * 192 * 100 * 101 / 2)
    assert oc.kernels["flash_attention"]["bytes"] == 2 * 2 * 2 * 100 * 192 * (
        16 + 4)
    assert dict(oc.op_histogram())["kernel.flash_attention"] == 1
    # under autograd: the output, and the backward's gradients
    qg = q.clone().requires_grad_()
    g = torch.autograd.grad(KA.flash_attention(qg, kv, kv).sum(), qg)[0]
    assert g.shape == q.shape and g.device.type == m
    qd = torch.empty(2, 16, 128, dtype=torch.bfloat16, device=m)
    cache = torch.empty(2, 4096, 4, 128, dtype=torch.bfloat16, device=m)
    assert KD.flash_decode(qd, cache, cache, 4000).shape == qd.shape
    a = torch.empty(2, 50, 64, 16, device=m)
    Cm = torch.empty(2, 50, 16, device=m)
    h0 = torch.empty(2, 64, 16, device=m)
    y, h, st = KS.selective_scan_fwd(a, a, Cm, h0, keep_states=True)
    assert (y.shape, h.shape, st.shape) == ((2, 50, 64), (2, 64, 16),
                                           (2, 4, 64, 16))
    da, db, dC, dh0 = KS.selective_scan_bwd(a, a, Cm, h0, y, None, st)
    assert (da.shape, dC.shape, dh0.shape) == (a.shape, Cm.shape, h0.shape)
    ag = a.clone().requires_grad_()
    yg, _ = KS.selective_scan(ag, a, Cm, h0)
    assert torch.autograd.grad(yg.sum(), ag)[0].shape == a.shape
    assert counts == (KA.launches, KA.bwd_launches, KD.launches,
                      KS.launches, KS.bwd_launches)     # none launched
    with pytest.raises(ValueError):
        KA.flash_attention_fwd(q, kv[:, :50], kv)


class _DataCheck(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on any op whose result holds data (not ``meta``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in op_cost._tensors(out):
            assert t.device.type == "meta", (func, t.device)
        return out


@pytest.mark.parametrize("arch,shape_name", [
    ("dbrx-132b", "prefill_32k"), ("jamba-v0.1-52b", "long_500k"),
    ("deepseek-v2-lite-16b", "decode_32k")])
def test_planner_allocates_no_data(arch, shape_name):
    """A cell whose step would hold hundreds of GB plans on ``meta``:
    every op's result is a meta tensor, and the record adds up."""
    with _DataCheck():
        rec = D.plan_cell(arch, shape_name, make_test_mesh(1))
    assert rec["n_devices"] == 1 and rec["flops"] > 0
    args = rec["per_device_bytes"]
    assert rec["argument_bytes_per_device"] == sum(args.values())
    assert rec["argument_bytes_allocated"] >= rec["argument_bytes_per_device"]
    assert rec["predicted_peak_bytes_per_device"] == (
        rec["argument_bytes_allocated"] + rec["step_peak_bytes"])
    four = D.plan_cell(arch, shape_name, make_test_mesh(4))
    assert four["argument_bytes_per_device"] < rec[
        "argument_bytes_per_device"]
    assert four["flops"] == rec["flops"]
    assert four["flops_per_device"] == rec["flops"] / 4


def test_train_plan_counts_the_step():
    """The smoke llama's train cell: every layer's kernels (forward and
    rematerialised recompute a microbatch, one backward), the gradients'
    and sums' bytes, AdamW's ops."""
    cfg = get_smoke("llama3.2-1b")
    shape = ShapeConfig("t", 64, 8, "train", accum_steps=2)
    rec = D.plan(cfg, shape, make_test_mesh(1))
    n = cfg.n_layers
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * 2 * n
    assert rec["kernels"]["flash_attention_bwd"]["calls"] == 2 * n
    params = sum(p.numel() * p.element_size()
                 for p in T.init_abstract(cfg).parameters())
    args = rec["per_device_bytes"]
    assert args["params"] == args["gradients"] == params
    assert args["moments"] == 2 * args["grad_sums"]
    assert args["step"] == 4 and args["inputs"] == 8 * 64 * 4
    assert rec["step_peak_bytes"] > args["grad_sums"]
    assert rec["dot_flops"] > 6 * T.param_count(cfg)[1] * 8 * 64 * 0.5


def test_cli_runs_without_jax(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        f"rc = dryrun.main(['--arch', 'llama3.2-1b', '--shape', "
        f"'decode_32k', '--mesh', 'h100x4', '--out', {str(tmp_path)!r}, "
        f"'--set', 'n_layers=2'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k__h100x4.json")
                     .read_text())
    assert rec["n_devices"] == 4 and rec["n_layers"] == 2
    assert rec["overrides"] == {"n_layers": 2}
    assert D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                   "--out", str(tmp_path), "--set", "n_layers=2",
                   "--mesh", "h100x4"]) == 0      # kept: skipped


def test_bytes_per_wg_from_ops():
    from repro_torch.kernels.gaussian import ops as gops, ref as RG
    from repro_torch.tune.calibrate import bytes_per_wg_from_ops
    rows = 2 * gops.LWS
    img = np.random.default_rng(0).standard_normal((rows, 48)).astype(
        np.float32)
    ip, w = (torch.from_numpy(x) for x in gops.prepare(img))
    with op_cost.OpCost() as oc:
        RG.blur_rows_ref(ip, w, 0, rows)
    got = bytes_per_wg_from_ops(2, RG.blur_rows_ref, ip, w, 0, rows)
    assert got == oc.traffic_bytes / 2 > 0
    a, b = torch.randn(8, 4), torch.randn(4, 2)
    assert bytes_per_wg_from_ops(2, torch.mm, a, b) == 4 * (32 + 8 + 16) / 2
    with pytest.raises(ValueError):
        bytes_per_wg_from_ops(0, torch.mm, a, b)
