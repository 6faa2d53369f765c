"""Sharded serving of caches split by positions on the ("data", "model")
= (1, 4) mesh against the JAX package, on the CPU.

The JAX resolver puts a cache's "kv_seq" on the "model" axis wherever
its kv heads cannot take it: every MLA cache (deepseek-v2-lite-16b) and
GQA's with kv heads that do not divide by 4 (internvl2-1b).  Each rank
then holds a stretch of positions, and a decode step combines the ranks'
partials by their log-sum-exps (``flash_decode_partial``,
``ShardedRun.combine_lse``).

* Four ``gloo`` ranks, spawned once for both smoke configs, load the JAX
  parameters from ``.npz`` (no ``jax`` or ``repro`` in a rank).  A cache
  of 16 splits into stretches of 4 (asserted): the prompt of 5 leaves
  ranks 2 and 3 empty and the 8 teacher-forced decode steps cross into
  both.  Prefill and decode logits equal the JAX package's unsharded
  jitted steps at rtol = atol = 2e-4 and are bitwise equal on the four
  ranks; the ranks' caches made whole after the prefill equal the JAX
  package's; routing equals the one-process port's.  A cache of 35 does
  not divide by 4: every rank keeps every position, and the logits equal
  the JAX package's too.
* The planner's record of each smoke cell predicts rank 0's counted
  collectives, the combine's max and sum among them.
* Without ranks: the plain partial over four stretches (one empty) and
  the combine against ``decode_attention`` over the whole cache; an
  unsplit cache runs the layer's ops of a run without ``res``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _kvseq_rank as K
import _sharded_rank as R
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro.training import step as JSTEP
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_decode import kernel as KD
from repro_torch.kernels.flash_decode import ref as RD
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import coords, make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import spmd
from repro_torch.parallel.collectives import ShardedRun, sharded_run
from repro_torch.parallel.sharding import local_slice

TOL = dict(rtol=2e-4, atol=2e-4)
MESH = make_test_mesh(K.WORLD)
# one spawned rank set runs both configs, each on a split and a whole
# cache
RANKS_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_run(jcfg, jparams, tokens, max_seq):
    """The JAX package's unsharded steps, teacher-forced as the ranks:
    (the logits, stacked; the cache right after the prefill)."""
    cache, _ = JT.init_cache(jcfg, K.B, max_seq)
    lg, cache = jax.jit(JSTEP.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :K.P])}, cache)
    prefilled = jax.tree.map(np.asarray, cache)
    outs = [lg]
    step = jax.jit(JSTEP.make_decode_step(jcfg))
    for i in range(K.P, K.P + K.STEPS):
        lg, cache = step(jparams, jnp.asarray(tokens[:, i:i + 1]), cache,
                         jnp.int32(i))
        outs.append(lg)
    return np.stack([np.asarray(o) for o in outs]), prefilled


def _jax_layer_cache(jcfg, jcache, i):
    """Layer ``i``'s cache entries in the JAX package's tree (its leading
    dense layers, then sub-layer (i - first_dense) % period of block
    (i - first_dense) // period)."""
    fd = jcfg.moe.first_dense
    if i < fd:
        return jcache["pre_blocks"][i]["mixer"]
    b, sub = divmod(i - fd, jcfg.block_period)
    blocks = jcache["blocks"]
    if isinstance(blocks, list):
        return blocks[b][f"sub{sub}"]["mixer"]
    return {k: v[b] for k, v in blocks[f"sub{sub}"]["mixer"].items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per arch: the JAX logits on a split-size and a whole-size cache,
    the JAX cache after the prefill, the one-process port's routes; and
    the four ranks' results."""
    case_dir = tmp_path_factory.mktemp("kvseq")
    want = {}
    for arch in K.ARCHS:
        cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jparams = jax.tree.map(np.asarray, jparams)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (K.B, K.P + K.STEPS)).astype(np.int32)
        np.savez(case_dir / f"{arch}.npz", __tokens__=tokens,
                 **R.flatten(jparams))
        split, jcache = _jax_run(jcfg, jparams, tokens, K.SPLIT_SEQ)
        kept, _ = _jax_run(jcfg, jparams, tokens, K.WHOLE_SEQ)
        one = params_from_jax(cfg, jparams, device="cpu")
        _, _, routes = K.run_cache(cfg, one, tokens, K.SPLIT_SEQ)
        want[arch] = dict(split=split, kept=kept, routes=routes,
                          cache=[_jax_layer_cache(jcfg, jcache, i)
                                 for i in range(cfg.n_layers)])
    ranks = spmd.run(K.kvseq_cases, K.WORLD, store_dir=str(case_dir),
                     backend="gloo", device="cpu", args=(str(case_dir),),
                     timeout=RANKS_TIMEOUT_S)
    return want, ranks


@pytest.mark.parametrize("arch", K.ARCHS)
def test_caches_split_by_position_over_the_ranks(served, arch):
    """Each rank holds a quarter of the positions of every attention
    cache entry, in rank order; a cache of 35 stays whole on each."""
    _, ranks = served
    for r, got in enumerate(ranks):
        quarter = K.SPLIT_SEQ // K.WORLD
        assert got[arch]["stretch"] == (r * quarter, quarter)
        assert got[arch]["kept_stretch"] is None
        for entry in got[arch]["cache"]:
            for t in entry.values():
                assert t.shape[:2] == (K.B, quarter)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_split_cache_logits_match_jax(served, arch):
    want, ranks = served
    for r in ranks:
        got = r[arch]["split"]
        assert got.shape == want[arch]["split"].shape
        np.testing.assert_allclose(got, want[arch]["split"], **TOL)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_whole_cache_under_ranks_matches_jax(served, arch):
    """``max_seq`` 35: the resolver replicates "kv_seq", so the layers
    run their unsplit path (deepseek's heads still split)."""
    want, ranks = served
    for r in ranks:
        np.testing.assert_allclose(r[arch]["kept"], want[arch]["kept"],
                                   **TOL)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_logits_bitwise_equal_on_every_rank(served, arch):
    _, ranks = served
    for key in ("split", "kept"):
        first = ranks[0][arch][key]
        assert np.isfinite(first).all()
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[arch][key], first)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_rank_caches_made_whole_equal_jax(served, arch):
    """The four ranks' stretches after the prefill, placed by the
    resolver's spec, make the JAX package's cache: the prompt's rows, and
    zeros past them."""
    want, ranks = served
    cfg = get_smoke(arch)
    res = sharded_run(cfg, MESH)
    meta = T.init_cache(cfg, K.B, K.SPLIT_SEQ, device="meta")
    axes = T.cache_axes(cfg, meta)
    for i, entry in enumerate(axes):
        for k, ax in entry.items():
            shape = meta[i][k].shape
            spec = res.resolver.spec(ax, shape)
            whole = np.zeros(shape, dtype=np.float32)
            for r, got in enumerate(ranks):
                whole[local_slice(MESH, spec, shape, coords(MESH, r))] = \
                    got[arch]["cache"][i][k]
            ref = want[arch]["cache"][i][k]
            assert whole.shape == ref.shape
            np.testing.assert_allclose(whole, ref, **TOL)
            assert not whole[:, K.P:].any()


def test_moe_routing_equals_one_process_run(served):
    want, ranks = served
    routes = want["deepseek-v2-lite-16b"]["routes"]
    assert routes
    for r in ranks:
        got = r["deepseek-v2-lite-16b"]["routes"]
        assert len(got) == len(routes)
        for a, b in zip(got, routes):
            np.testing.assert_array_equal(a, b)


def test_ranks_import_neither_jax_nor_repro(served):
    for r in served[1]:
        assert not [m for m in r["modules"]
                    if m.split(".")[0] in ("jax", "repro")]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", K.ARCHS)
def test_plan_predicts_the_ranks_collectives(served, arch, kind):
    """``plan`` of the smoke cell on (1, 4) runs rank 0's step on
    ``meta``: its collectives are those rank 0 counted, kind by kind.  A
    decode step adds the combine's max and sum a layer (and MLA's gather
    of its latent queries); a prefill has neither."""
    cfg = get_smoke(arch)
    rec = D.plan(cfg, ShapeConfig(kind, K.SPLIT_SEQ, K.B, kind), MESH)
    got = served[1][0][arch]["plan"][kind]
    assert got and rec["collectives"] == got
    assert rec["sharded_step"]["collectives"] == got
    one = D.plan(cfg, ShapeConfig(kind, K.SPLIT_SEQ, K.B, kind),
                 make_test_mesh(1))
    assert one["collectives"] == {}
    n, mla = cfg.n_layers, cfg.attn_kind == "mla"
    gathers = got.get("all-gather", {}).get("count", 0)
    # the vocab-split head's gather, and MLA's a layer at decode
    assert gathers == 1 + (n if mla and kind == "decode" else 0)
    # internvl2-1b's heads do not split: no all-reduce after wo; its MLP
    # and the vocab-split embedding add one each.  deepseek: wo's, the
    # dense MLP's, each MoE layer's routed and shared sums, the embedding
    mlps = (n if not mla else 1 + 2 * (n - 1))
    heads = n if mla else 0
    combine = 2 * n if kind == "decode" else 0
    assert got["all-reduce"]["count"] == 1 + mlps + heads + combine


# ---------------------------------------------------------------- units
class _Stacked(ShardedRun):
    """Four ranks in one process: every tensor carries the ranks along a
    leading dim, and a collective reduces over it."""

    def __init__(self):
        super().__init__(None, {"model": 0})

    def _reduce(self, x, op="sum"):
        y = x.amax(0) if op == "max" else x.sum(0)
        return y.expand_as(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 11, 15])
def test_partial_and_combine_over_four_stretches(pos, dtype):
    """Each stretch's partial over its live rows (none past ``pos``: a
    stretch that starts after it is empty, lse -inf), combined, equals
    ``decode_attention`` over the whole cache; an empty stretch's weight
    is exactly 0."""
    g = torch.Generator().manual_seed(pos)
    Bq, H, KH, Dh, S = 2, 14, 2, 64, 16
    q = torch.randn(Bq, H, Dh, generator=g).to(dtype)
    k = torch.randn(Bq, S, KH, Dh, generator=g).to(dtype)
    v = torch.randn(Bq, S, KH, Dh, generator=g).to(dtype)
    want = RD.decode_attention(q, k, v, pos)
    n = S // 4
    parts = [KD.flash_decode_partial(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
        L._live(pos, (r * n, n))) for r in range(4)]
    for r, (o, lse) in enumerate(parts):
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == (Bq, H, Dh) and lse.shape == (Bq, H)
        if r * n > pos:
            assert not o.any() and bool((lse == -math.inf).all())
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    got = _Stacked().combine_lse(o, lse, dtype)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    for r in range(1, 4):
        assert torch.equal(got[r], got[0])
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[0].float(), want.float(), **tol)
    m = lse.amax(0)
    assert bool((torch.exp(lse[[r for r in range(4) if r * n > pos]] - m)
                 == 0).all())


def test_partial_lse_is_the_scores_logsumexp():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 16, generator=g),
               torch.randn(2, 8, 2, 16, generator=g),
               torch.randn(2, 8, 2, 16, generator=g))
    o, lse = KD.flash_decode_partial(q, k, v, 6)
    s = torch.einsum("bkgd,bskd->bkgs", q.view(2, 2, 2, 16), k[:, :6])
    want = torch.logsumexp(s / 4.0, dim=-1).reshape(2, 4)
    torch.testing.assert_close(lse, want)
    torch.testing.assert_close(o, RD.decode_attention(q, k, v, 5))
    with pytest.raises(ValueError):
        KD.flash_decode_partial(q.to("meta"), k.to("meta"), v.to("meta"),
                                9)


def test_partial_on_meta_tallies_the_live_rows():
    q = torch.empty(2, 14, 64, device="meta")
    k = torch.empty(2, 8, 2, 64, device="meta")
    KD.meta_cost.clear()
    o, lse = KD.flash_decode_partial(q, k, k, 5)
    assert o.shape == (2, 14, 64) and lse.shape == (2, 14)
    assert o.dtype == lse.dtype == torch.float32
    t = KD.meta_cost["flash_decode"]
    assert t["calls"] == 1 and t["flops"] == 4.0 * 2 * 14 * 64 * 5
    assert t["bytes"] == (4 * 2 * 2 * 5 * 2 * 64 + 4 * 2 * 14 * 64
                          + 4 * 2 * 14 * (64 + 1))
    KD.flash_decode_partial(q, k, k, 0)   # an empty stretch tallies none
    assert KD.meta_cost["flash_decode"]["calls"] == 1
    KD.meta_cost.clear()


@pytest.mark.parametrize("max_seq, split", [(35, False), (16, True)])
def test_layer_reads_the_layout_from_the_resolver(max_seq, split):
    """internvl2-1b's GQA layer under ``res`` of rank 2: with a cache of
    35 the resolver keeps every position on every rank and the prefill
    and the decode step are those of a run without ``res``, bit for bit;
    with 16 it holds positions 8 ... 11 and writes only those."""
    cfg = get_smoke("internvl2-1b")
    p = T.init_params(cfg, torch.Generator().manual_seed(0)).layers[0].mixer
    res = sharded_run(cfg, MESH, rank=2)
    x = torch.randn(K.B, 10, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    hd = cfg.resolved_head_dim
    whole = (K.B, max_seq, cfg.n_kv_heads, hd)
    want = res.kv_stretch(L.GQA_CACHE_AXES["k"], whole)
    assert want == ((8, max_seq // 4) if split else None)
    ref = L.gqa_cache_init(cfg, K.B, max_seq, torch.float32, "cpu")
    y0, _ = L.gqa_apply(cfg, p, x[:, :9], torch.arange(9), cache=ref)
    if split:
        cache = {k: torch.zeros(K.B, 4, *t.shape[2:]) for k, t in ref.items()}
        L.gqa_apply(cfg, p, x[:, :9], torch.arange(9), cache=cache, res=res,
                    max_seq=max_seq)
        for k in cache:
            assert torch.equal(cache[k][:, :1], ref[k][:, 8:9])
            assert not cache[k][:, 1:].any()
        return
    cache = {k: torch.zeros_like(t) for k, t in ref.items()}
    y1, _ = L.gqa_apply(cfg, p, x[:, :9], torch.arange(9), cache=cache,
                        res=res, max_seq=max_seq)
    assert torch.equal(y0, y1)
    d0, _ = L.gqa_apply(cfg, p, x[:, 9:], torch.tensor([9]), cache=ref,
                        pos=9)
    d1, _ = L.gqa_apply(cfg, p, x[:, 9:], torch.tensor([9]), cache=cache,
                        pos=9, res=res, max_seq=max_seq)
    assert torch.equal(d0, d1)
    for k in cache:
        assert torch.equal(cache[k], ref[k])


def test_sharded_run_needs_the_rank_cache():
    cfg = dataclasses.replace(get_smoke("internvl2-1b"), n_layers=1)
    res = sharded_run(cfg, MESH)
    params = T.shard_params(cfg, T.init_params(
        cfg, torch.Generator().manual_seed(0)), res)
    with pytest.raises(ValueError, match="init_cache"):
        T.prefill(cfg, params, torch.zeros(1, 4, dtype=torch.long),
                  T.init_cache(cfg, 1, 16, device="cpu"), res=res)
    cache = T.init_cache(cfg, 1, 16, device="cpu", res=res)
    assert isinstance(cache, T.RankCache) and cache.max_seq == 16
    assert cache[0]["k"].shape[1] == 4


def test_c_entry_points_match_their_ctypes_prototypes():
    """Each ``extern "C"`` entry point of ``csrc/*.cu`` that
    ``kernels/build.py`` binds takes the arguments its ctypes prototype
    names, in order: a pointer passed where the prototype says ``int``
    is cut to 32 bits (``flash_decode_fwd`` gained its lse pointer)."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels import build

    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    text = "".join(p.read_text() for p in sorted(Path(build.CSRC).glob(
        "*.cu")))
    for name, proto in build.PROTOTYPES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m, name
        got = [ctypes.c_void_p if "*" in a else
               kinds[" ".join(a.split()[:-1]).replace("const ", "")]
               for a in m.group(1).split(",")]
        assert got == proto, name
