"""The port's sharding resolver and logical axes
(``repro_torch.parallel.sharding``, ``transformer.param_axes`` /
``cache_axes``) against the JAX package's, on the CPU.

Specs are compared exactly: every case of ``tests/test_sharding.py``,
and every parameter and cache entry of every config at full width on the
JAX package's production meshes (16x16, 2x16x16) and the port's card
meshes (1, 1) and (1, 4), JAX meshes built from one repeated CPU device
as ``tests/test_sharding.py`` builds them.  The port keeps one module a
layer where the JAX package stacks a block's layers, so a stacked JAX
leaf stands for several port parameters, each with the JAX leaf's axes
and spec less the leading stacked entry; the map from JAX leaves to port
names is ``models/convert.py``'s, checked on the smoke configs."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.parallel.sharding import ShardingResolver as JResolver
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import (card_mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import Mesh, ShardingResolver

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x1": make_test_mesh(1), "1x4": make_test_mesh(4)}


def jax_mesh(mesh: Mesh) -> JMesh:
    devs = np.array(jax.devices()[:1] * mesh.size).reshape(mesh.shape)
    return JMesh(devs, mesh.axis_names)


def is_ax(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def jax_leaves(tree, axes):
    """[(path as a tuple of keys, leaf, logical axes)] of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ax = jax.tree_util.tree_leaves(axes, is_leaf=is_ax)
    assert len(flat) == len(ax)
    return [(tuple(_key(k) for k in path), leaf, a)
            for (path, leaf), a in zip(flat, ax)]


def port_names(cfg, path):
    """The port's names of a JAX parameter or cache leaf at ``path``,
    and whether the leaf is stacked (one name a block, the leading dim
    the block): the layout ``models/convert.py`` maps."""
    P_, first = cfg.block_period, cfg.moe.first_dense
    if path[0] in ("embed", "final_norm", "lm_head"):
        return [path[0]], False
    if path[0] == "pre_blocks":
        layers, rest, stacked = [path[1]], path[2:], False
    elif isinstance(path[1], int):              # unrolled cache blocks
        layers = [first + path[1] * P_ + int(path[2][3:])]
        rest, stacked = path[3:], False
    else:                                       # stacked blocks
        j = int(path[1][3:])
        n_blocks = (cfg.n_layers - first) // P_
        layers = [first + b * P_ + j for b in range(n_blocks)]
        rest, stacked = path[2:], True
    return [".".join(str(x) for x in ("layers", i) + rest)
            for i in layers], stacked


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return JT.init_abstract(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    cfg = get_config(arch)
    params = T.init_abstract(cfg)
    return params, T.param_axes(cfg, params)


def _jax_cache(arch, batch=8, seq=64):
    cfg = jax_get_config(arch)
    captured = {}

    def build():
        c, a = JT.init_cache(cfg, batch, seq)
        captured["axes"] = a
        return c
    return jax.eval_shape(build), captured["axes"]


# ----------------------------------------------- tests/test_sharding.py
def _mesh2d(data=2, model=2):
    return Mesh(("data", "model"), (data, model))


RESOLVER_CASES = [
    # (mesh, fsdp, logical, shape, param): test_sharding.py's cases
    (_mesh2d(), False, ("d_model", "heads", None), (64, 8, 16), False),
    (_mesh2d(), False, ("d_model", "heads", None), (64, 7, 16), False),
    (_mesh2d(), False, ("vocab", "d_model"), (151655, 896), False),
    (_mesh2d(), False, ("vocab", "d_model"), (151655, 896), True),
    (_mesh2d(), True, ("vocab", "d_model"), (151655, 896), True),
    (Mesh(("pod", "data", "model"), (2, 2, 2)), False,
     ("batch", "seq", None), (8, 16, 4), False),
    (_mesh2d(), False, ("batch", "seq", None), (1, 16, 4), False),
    (_mesh2d(), False, ("experts", "d_ff"), (4, 8), False),
    (_mesh2d(2, 4), False, ("batch", "kv_seq", "kv_heads", None),
     (8, 64, 2, 16), False),
    (_mesh2d(), True, ("d_model", "d_ff"), (64, 256), True),
    (_mesh2d(), False, ("d_model", "d_ff"), (8, 16), False),
    (_mesh2d(), False, ("d_ff",), (16,), False),
]


@pytest.mark.parametrize("mesh,fsdp,logical,shape,param", RESOLVER_CASES)
def test_spec_equals_reference_on_sharding_cases(mesh, fsdp, logical, shape,
                                                 param):
    want = JResolver(jax_mesh(mesh), fsdp=fsdp).spec(logical, shape,
                                                     param=param)
    got = ShardingResolver(mesh, fsdp=fsdp).spec(logical, shape, param=param)
    assert got == tuple(want)
    assert P(*got) == want


def test_tree_specs_and_shard_shape():
    r = ShardingResolver(_mesh2d())
    shapes = S.shapes_of({"w": torch.empty(8, 16), "b": torch.empty(16)})
    specs = r.tree_specs({"w": ("d_model", "d_ff"), "b": ("d_ff",)}, shapes)
    assert specs == {"w": (None, "model"), "b": ("model",)}
    assert S.shard_shape(r.mesh, specs["w"], (8, 16)) == (8, 8)
    spec = r.spec(("batch", "seq", None), (8, 16, 4))
    assert S.shard_shape(r.mesh, spec, (8, 16, 4)) == (4, 16, 4)
    three = Mesh(("pod", "data", "model"), (2, 2, 2))
    assert S.shard_shape(three, (("pod", "data"), None), (8, 3)) == (2, 3)
    with pytest.raises(ValueError):
        S.shard_shape(three, ("model",), (3,))


def test_constrain_is_the_identity_and_meshes():
    x = torch.ones(3)
    assert S.constrain(x, ShardingResolver(_mesh2d()), ("batch",)) is x
    assert make_production_mesh().shape == (16, 16)
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert make_test_mesh(1).shape == (1, 1)
    assert make_test_mesh(4).shape == (1, 4)
    assert make_test_mesh(6).shape == (6, 1)
    assert card_mesh("h100x4").size == 4 and card_mesh("h100").tag == "1x1"
    with pytest.raises(ValueError):
        Mesh(("data",), (0,))


# -------------------------------------------------- the port's axes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_names_are_converts(arch):
    """``port_names`` maps each JAX leaf where ``convert.params_from_jax``
    puts it: on the smoke config, leaf i of block b filled with 1000 i +
    b lands in the port parameters of those names."""
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    params, axes = JT.init_abstract(jcfg)
    leaves = jax_leaves(params, axes)
    filled = []
    for i, (path, leaf, _) in enumerate(leaves):
        a = np.full(leaf.shape, 1000.0 * i, np.float32)
        if port_names(cfg, path)[1]:
            a += np.arange(leaf.shape[0], dtype=np.float32).reshape(
                (-1,) + (1,) * (len(leaf.shape) - 1))
        filled.append(a)
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), filled)
    named = convert.named_from_jax(cfg, tree, device="cpu")
    seen = set()
    for i, (path, leaf, _) in enumerate(leaves):
        names, stacked = port_names(cfg, path)
        for b, n in enumerate(names):
            assert float(named[n].flatten()[0]) == 1000.0 * i + (
                b if stacked else 0), (path, n)
            seen.add(n)
    assert seen == set(named)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_reference(arch):
    """``param_axes`` and ``cache_axes`` give each port tensor its JAX
    leaf's axes (less the stacked blocks' leading None), and
    ``logical_shape`` its JAX leaf's shape (less the leading block dim)."""
    cfg = get_config(arch)
    params, axes = port_params(arch)
    shapes = dict((n, p.shape) for n, p in params.named_parameters())
    got = {}
    for path, leaf, ax in jax_leaves(*jax_params(arch)):
        names, stacked = port_names(cfg, path)
        for n in names:
            want_ax = ax[1:] if stacked else ax
            want_shape = leaf.shape[1:] if stacked else leaf.shape
            assert axes[n] == want_ax, n
            assert T.logical_shape(cfg, axes[n], shapes[n]) == want_shape, n
            got[n] = True
    assert set(got) == set(axes)
    cache = T.init_cache(cfg, 8, 64, device="meta")
    caxes = T.cache_axes(cfg, cache)
    count = 0
    for path, leaf, ax in jax_leaves(*_jax_cache(arch)):
        names, stacked = port_names(cfg, path)
        for n in names:
            layer, key = int(n.split(".")[1]), n.split(".")[-1]
            assert caxes[layer][key] == (ax[1:] if stacked else ax)
            assert tuple(cache[layer][key].shape) == (
                leaf.shape[1:] if stacked else leaf.shape)
            count += 1
    assert count == sum(len(c) for c in cache)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_on_every_leaf(arch, mesh_name):
    """Every parameter (without and with FSDP) and cache entry of the
    config at full width: the port's spec is the JAX package's, exactly."""
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    jm = jax_mesh(mesh)
    params, axes = port_params(arch)
    shapes = dict((n, p.shape) for n, p in params.named_parameters())
    for fsdp in (False, True):
        jr, r = JResolver(jm, fsdp=fsdp), ShardingResolver(mesh, fsdp=fsdp)
        for path, leaf, ax in jax_leaves(*jax_params(arch)):
            want = tuple(jr.spec(ax, leaf.shape, param=True))
            names, stacked = port_names(cfg, path)
            if stacked:
                assert want[0] is None
                want = want[1:]
            for n in names:
                shape = T.logical_shape(cfg, axes[n], shapes[n])
                assert r.spec(axes[n], shape, param=True) == want, (n, fsdp)
    cache = T.init_cache(cfg, 8, 64, device="meta")
    caxes = T.cache_axes(cfg, cache)
    jr, r = JResolver(jm), ShardingResolver(mesh)
    for path, leaf, ax in jax_leaves(*_jax_cache(arch)):
        want = tuple(jr.spec(ax, leaf.shape))
        names, stacked = port_names(cfg, path)
        for n in names:
            layer, key = int(n.split(".")[1]), n.split(".")[-1]
            c = cache[layer][key]
            assert r.spec(caxes[layer][key], c.shape) == (
                want[1:] if stacked else want), n
