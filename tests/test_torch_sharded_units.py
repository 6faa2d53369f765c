"""The parts of sharded serving that need no rank set of their own: a
rank's block of a tensor (``local_slice``) and of a model
(``shard_params``, ``init_cache(res=...)``), mesh coordinates, what
``check_shardable`` takes and refuses, ``parallel/spmd.py``'s failures and
timeouts, ``OpCost``'s collective counts under the ``fake`` backend, and
the planner's ``sharded_step`` records (and the cells that keep none).
The four-rank runs against the JAX package are
``tests/test_torch_sharded.py``."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import _sharded_rank as R
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import card_mesh, coords, make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import spmd
from repro_torch.parallel.collectives import sharded_run
from repro_torch.parallel.sharding import Mesh, local_slice, shard_shape

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESH = make_test_mesh(4)
# the configs whose caches the resolver splits by positions ("kv_seq")
KVSEQ = ("internvl2-1b", "deepseek-v2-lite-16b")
SHARDABLE = [a for a in ARCH_IDS if a not in KVSEQ]


# ------------------------------------------------------------- blocks
def test_mesh_coords_are_row_major():
    assert [coords(MESH, r) for r in range(4)] == [
        {"data": 0, "model": r} for r in range(4)]
    m = Mesh(("pod", "data", "model"), (2, 3, 2))
    assert coords(m, 7) == {"pod": 1, "data": 0, "model": 1}
    with pytest.raises(ValueError):
        coords(MESH, 4)


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None),
                                  (("pod", "data"), "model")])
def test_local_slices_tile_the_tensor(spec):
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    t = torch.arange(8 * 6).reshape(8, 6)
    seen = torch.zeros_like(t)
    blocks = {}
    for r in range(mesh.size):
        sl = local_slice(mesh, spec, t.shape, coords(mesh, r))
        block = t[sl]
        assert tuple(block.shape) == shard_shape(mesh, spec, t.shape)
        seen[sl] += 1
        blocks[tuple((s.start, s.stop) for s in sl)] = block
    # every element held once by each replica of its block
    assert int(seen.min()) == int(seen.max()) == mesh.size // len(blocks)
    if spec[0] == ("pod", "data"):     # pod the slowest of the two
        sl = local_slice(mesh, spec, t.shape, {"pod": 1, "data": 0,
                                               "model": 0})
        assert sl[0] == slice(4, 6)


def _jamba():
    return R.with_heads(get_smoke("jamba-v0.1-52b"))


def _ranks(cfg, params):
    out = []
    for r in range(4):
        res = sharded_run(cfg, MESH, rank=r)
        out.append((res, T.shard_params(cfg, params, res)))
    return out


def test_shard_params_blocks_add_up_to_the_model():
    cfg = _jamba()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    ranks = _ranks(cfg, params)
    whole = dict(params.named_parameters())
    for name, p in whole.items():
        parts = [dict(lp.named_parameters())[name] for _, lp in ranks]
        if all(q.shape == p.shape for q in parts):       # replicated
            assert all(torch.equal(q, p) for q in parts), name
            continue
        if name.endswith("mixer.in_proj"):               # x and z halves
            x, z = p.chunk(2, dim=1)
            halves = [q.chunk(2, dim=1) for q in parts]
            assert torch.equal(torch.cat([h[0] for h in halves], 1), x)
            assert torch.equal(torch.cat([h[1] for h in halves], 1), z)
            continue
        dim = next(i for i in range(p.dim()) if parts[0].shape[i]
                   != p.shape[i])
        assert torch.equal(torch.cat(parts, dim), p), name
    mixer = ranks[1][1].layers[2].mixer
    assert isinstance(mixer, L.GQA)
    hd = cfg.resolved_head_dim
    assert mixer.wq.shape == (cfg.d_model, cfg.n_heads // 4 * hd)
    assert mixer.wk.shape == (cfg.d_model, cfg.n_kv_heads // 4 * hd)
    assert ranks[3][1].layers[0].mlp.w_gate.shape[0] == cfg.moe.n_routed // 4
    # the whole model is left as it was
    assert dict(params.named_parameters()).keys() == whole.keys()


def test_tied_embedding_split_once_over_vocab():
    cfg = R.with_heads(get_smoke("llama3.2-1b"))
    assert cfg.tie_embeddings
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    _, lp = _ranks(cfg, params)[2]
    assert lp.lm_head is None
    V = cfg.vocab_size // 4
    assert torch.equal(lp.embed, params.embed[2 * V:3 * V])


def test_init_cache_gives_the_ranks_blocks():
    cfg = _jamba()
    res = sharded_run(cfg, MESH, rank=1)
    cache = T.init_cache(cfg, 2, 16, device="cpu", res=res)
    whole = T.init_cache(cfg, 2, 16, device="cpu")
    for c, w in zip(cache, whole):
        for k, t in c.items():
            want = list(w[k].shape)
            split = 2 if k in ("k", "v") else (1 if k == "h" else 2)
            want[split] //= 4
            assert list(t.shape) == want and t.dtype == w[k].dtype, k
            assert not t.any()


# ----------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", KVSEQ)
def test_check_shardable_refuses_caches_over_kv_seq(arch):
    """No longer refused: the two configs whose caches the resolver puts
    over "kv_seq" pass, and each rank's cache is a stretch of a quarter
    of the positions."""
    cfg = get_config(arch)
    T.check_shardable(cfg, MESH)
    res = sharded_run(cfg, MESH, rank=3)
    meta = T.init_cache(cfg, 1, 64, device="meta")
    for entry, ax in zip(meta, T.cache_axes(cfg, meta)):
        for k, t in entry.items():
            assert res.kv_stretch(ax[k], t.shape) == (48, 16), k
    cache = T.init_cache(cfg, 1, 64, device="meta", res=res)
    assert all(t.shape[1] == 16 for c in cache for t in c.values())


@pytest.mark.parametrize("arch", SHARDABLE)
def test_check_shardable_passes_the_other_configs(arch):
    T.check_shardable(get_config(arch), MESH)


def test_check_shardable_refuses_a_data_axis():
    """A "data" axis above 1 is taken, and so is a "pod" axis above 1,
    the JAX package's multi-pod mesh (``tests/test_torch_sharded_pod.py``):
    on ("pod", "data", "model") = (2, 1, 2) a batch of 4 splits its rows
    over ("pod", "data"), a batch of 1 is replicated over "pod"; a mesh
    of other axes is refused."""
    cfg = get_config("llama3.2-1b")
    T.check_shardable(cfg, Mesh(("data", "model"), (2, 2)))
    pod = Mesh(("pod", "data", "model"), (2, 1, 2))
    T.check_shardable(cfg, pod)
    T.check_trainable(cfg, pod, 4)
    for r in range(4):
        res = sharded_run(cfg, pod, rank=r, train=True)
        p = res.coords["pod"]
        assert res.rows(4) == slice(2 * p, 2 * p + 2)
        assert res.for_batch(4, 32).tokens.axes == ("pod",)
        one = res.for_batch(1, 32).tokens
        assert (one.rows, one.stretch, one.axes) == (slice(0, 1), None, ())
    with pytest.raises(ValueError, match="'pod', 'data' and 'model'"):
        T.check_shardable(cfg, Mesh(("expert", "model"), (2, 2)))


@pytest.mark.parametrize("batch, accum, ok", [
    (4, 1, True), (4, 2, True), (8, 2, True), (2, 2, False), (3, 1, False),
    (6, 2, False), (1, 1, False)])
def test_check_trainable_takes_batches_that_split_over_data(batch, accum,
                                                            ok):
    """On (2, 2) every batch is taken.  A microbatch whose rows split
    over "data" (``ok``) gives each "data" rank its block of them; one of
    1 row, or of odd rows, puts "seq" on "data" as the JAX resolver does:
    each rank holds every row and its half of the positions."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), **R.HEADS)
    mesh = card_mesh("h100x2x2")
    T.check_trainable(cfg, mesh)
    T.check_trainable(cfg, mesh, batch, accum)
    n = batch // accum
    for r in range(4):
        tok = sharded_run(cfg, mesh, rank=r, train=True).for_batch(
            n, 32).tokens
        d = coords(mesh, r)["data"]
        assert tok.axes == ("data",)
        if ok:
            assert tok.stretch is None
            assert tok.rows == slice(d * n // 2, (d + 1) * n // 2)
        else:
            assert tok.rows == slice(0, n) and tok.stretch == (16 * d, 16)
    # on (1, 4) every batch is taken, whole on every rank
    T.check_trainable(cfg, MESH, batch, accum)
    assert sharded_run(cfg, MESH).for_batch(n, 32).tokens.axes == ()


def test_train_step_refuses_a_batch_data_does_not_split():
    """What the train step still refuses on (2, 2): a batch that does
    not split into equal microbatches, and stretches of positions
    shorter than a Mamba conv's halo; a batch of 3 rows whose
    microbatch "data" does not divide is taken (its positions split)."""
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.training.step import make_train_step
    cfg = get_smoke("llama3.2-1b")
    res = sharded_run(cfg, card_mesh("h100x2x2"), rank=0, train=True)
    params = T.shard_params(cfg, T.init_abstract(cfg), res)
    state = init_state(params, OptConfig())
    tokens = torch.zeros((3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, OptConfig(), res=res, accum_steps=2)(
            state, {"tokens": tokens})
    T.check_batch(cfg, 3, 1)
    mamba = get_smoke("falcon-mamba-7b")
    with spmd.fake_group(4) as group:
        mres = sharded_run(mamba, card_mesh("h100x2x2"), group=group,
                           train=True)
        mstate = init_state(T.shard_params(
            mamba, T.init_abstract(mamba), mres), OptConfig())
        step = make_train_step(mamba, OptConfig(), res=mres)
        with pytest.raises(ValueError, match="halo"):
            step(mstate, {"tokens": torch.zeros((1, 4), dtype=torch.int32,
                                                device="meta")})
        step(mstate, {"tokens": torch.zeros((1, 6), dtype=torch.int32,
                                            device="meta")})


def test_rank_rows_and_groups_on_the_2x2_mesh():
    """Rank r of (2, 2) is ("data", "model") = divmod(r, 2): its rows are
    its "data" block of the batch (all of a batch of 1), and a rank run
    without a process group has neither group."""
    mesh = card_mesh("h100x2x2")
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), **R.HEADS)
    for r in range(4):
        res = sharded_run(cfg, mesh, rank=r)
        d, m = divmod(r, 2)
        assert (res.data_rank, res.rank, res.data_size, res.size) == (
            d, m, 2, 2)
        assert res.rows(8) == slice(4 * d, 4 * d + 4)
        assert res.rows(1) == slice(0, 1)
        assert res.group is None and res.data_group is None
    one = sharded_run(cfg, MESH, rank=1)
    assert (one.data_size, one.rows(4)) == (1, slice(0, 4))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_blocks_carry_their_data_dim(arch):
    """Under the training resolver on (2, 2) a block split over "data"
    is tagged with the dim the resolver chose, and ``split_axes`` lists
    it; on (1, 4) nothing is tagged and only "model" splits (the FSDP
    resolver splits nothing more while "data" is 1)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=full.block_period
                              + full.moe.first_dense)
    whole = T.init_abstract(cfg)
    res = sharded_run(cfg, card_mesh("h100x2x2"), train=True)
    blocks = T.shard_params(cfg, whole, res)
    axes = T.split_axes(cfg, res)
    tagged = {n for n, p in blocks.named_parameters() if hasattr(p, "fsdp")}
    assert tagged and tagged == {n for n, ax in axes.items() if "data" in ax}
    for n, p in blocks.named_parameters():
        if n in tagged:
            dim = p.fsdp[0]
            assert 2 * p.shape[dim] <= whole.get_parameter(n).shape[dim]
    tp = sharded_run(cfg, MESH, train=True)
    assert not any(hasattr(p, "fsdp") for p in
                   T.shard_params(cfg, whole, tp).parameters())
    assert all(ax == ("model",) for ax in T.split_axes(cfg, tp).values())


# --------------------------------------------------------------- spmd
def test_spmd_returns_results_by_rank(tmp_path):
    out = spmd.run(R.sum_of_ranks, 3, store_dir=str(tmp_path),
                   backend="gloo", device="cpu", timeout=90)
    assert out == [(r, 3, 6.0) for r in range(3)]


def test_spmd_raises_a_failing_ranks_error(tmp_path):
    with pytest.raises(RuntimeError, match="rank two fails on purpose"):
        spmd.run(R.rank_two_fails, 4, store_dir=str(tmp_path),
                 backend="gloo", device="cpu", timeout=90)


def test_spmd_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        spmd.run(R.never_returns, 2, store_dir=str(tmp_path),
                 backend="gloo", device="cpu", timeout=15)


def test_spmd_refuses_an_unknown_backend(tmp_path):
    with pytest.raises(ValueError):
        spmd.run(R.sum_of_ranks, 2, store_dir=str(tmp_path), backend="mpi",
                 device="cpu")


# ------------------------------------------------- collectives counted
def test_op_cost_counts_collectives_on_meta():
    c = torch.ops._c10d_functional
    x = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    with spmd.fake_group(4) as group:
        name = group.group_name
        with op_cost.OpCost() as oc:
            c.wait_tensor(c.all_reduce(x, "sum", name))
            c.wait_tensor(c.all_gather_into_tensor(x, 4, name))
            c.wait_tensor(c.reduce_scatter_tensor(x, "sum", 4, name))
        with pytest.raises(RuntimeError):
            with spmd.fake_group(2):
                pass
    assert not dist.is_initialized()
    got = oc.summary()
    assert got["collectives"] == {
        "all-reduce": {"count": 1.0, "result_bytes": 64.0,
                       "wire_bytes": 96.0},
        "all-gather": {"count": 1.0, "result_bytes": 256.0,
                       "wire_bytes": 192.0},
        "reduce-scatter": {"count": 1.0, "result_bytes": 16.0,
                           "wire_bytes": 48.0}}
    assert got["collective_wire_bytes"] == 96.0 + 192.0 + 48.0
    assert op_cost.collective_stats(oc) == got["collectives"]
    assert oc.hist["_c10d_functional.wait_tensor"] == 3
    assert got["flops"] == 0


# ------------------------------------------------------------ planner
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_h100x4_decode_records_the_sharded_step(arch):
    rec = D.plan_cell(arch, "decode_32k", card_mesh("h100x4"))
    step = rec["sharded_step"]
    assert "refused" not in step
    cfg = get_config(arch)
    # an all-reduce after each layer's mixer and MLP (Mamba's two; an MoE
    # layer's shared experts one more), one for the embedding; one gather
    # of the logits.  A cache split by positions: the combine's max and
    # sum a layer, MLA's gather of its latent queries; internvl2-1b's 14
    # heads and 151,655 tokens do not split (no all-reduce after wo or
    # the embedding, no gather of the logits)
    n = cfg.n_layers
    mamba = sum(cfg.mixer_kind(i) == "mamba" for i in range(n))
    mlps = sum(cfg.mlp_kind(i) == "moe" or cfg.d_ff > 0 for i in range(n))
    shared = sum(cfg.mlp_kind(i) == "moe" and cfg.moe.n_shared > 0
                 for i in range(n))
    vocab = int(cfg.vocab_size % 4 == 0)
    mixers = n if cfg.n_heads % 4 == 0 or cfg.attn_kind == "none" else 0
    combine = 2 * n if arch in KVSEQ else 0
    assert rec["collectives"]["all-reduce"]["count"] == (
        vocab + mixers + mamba + mlps + shared + combine)
    mla = n if cfg.attn_kind == "mla" else 0
    assert rec["collectives"].get("all-gather", {}).get("count", 0) == (
        vocab + mla)
    assert rec["collectives"] == step["collectives"]
    assert step["flops"] < rec["flops"]
    assert set(step["kernels"]) == set(rec["kernels"])
    assert step["predicted_peak_bytes"] == (
        rec["argument_bytes_per_device"] + step["peak_held_bytes"])
    # the even share keeps its meaning
    assert rec["flops_per_device"] == rec["flops"] / 4


@pytest.mark.parametrize("arch", KVSEQ)
def test_h100x4_prefill_records_split_the_cache(arch):
    """The two configs' ``prefill_32k`` records run rank 0's step: no
    combine at prefill (each rank attends over the whole prompt, then
    keeps its stretch), a device's cache a quarter of one card's."""
    rec = D.plan_cell(arch, "prefill_32k", card_mesh("h100x4"))
    step = rec["sharded_step"]
    assert "refused" not in step and step["collectives"]
    assert rec["collectives"] == step["collectives"]
    one = D.plan_cell(arch, "prefill_32k", card_mesh("h100"))
    assert 4 * rec["per_device_bytes"]["cache"] == one["per_device_bytes"][
        "cache"]
    assert step["predicted_peak_bytes"] == (
        rec["argument_bytes_per_device"] + step["peak_held_bytes"])


def test_one_card_and_training_records_keep_no_sharded_step():
    """On one card neither a serve nor a training record has a sharded
    step (a training record on (1, 4) has one since the planner runs
    rank 0's train step: ``tests/test_torch_sharded_train.py``)."""
    cfg = get_smoke("llama3.2-1b")
    one = D.plan(cfg, ShapeConfig("d", 32, 4, "decode"), make_test_mesh(1))
    train = D.plan(cfg, ShapeConfig("t", 32, 4, "train"), make_test_mesh(1))
    for rec in (one, train):
        assert "sharded_step" not in rec and rec["collectives"] == {}
        assert rec["collective_wire_bytes_per_device"] == 0.0


def test_planner_leaves_no_process_group():
    D.plan(dataclasses.replace(get_smoke("dbrx-132b"), **R.HEADS),
           ShapeConfig("p", 32, 4, "prefill"), MESH)
    assert not dist.is_initialized()


def test_cli_writes_the_sharded_step_without_jax(tmp_path):
    code = (
        "import sys; from repro_torch.launch import dryrun as D; "
        f"rc = D.main(['--arch', 'jamba-v0.1-52b', '--shape', "
        f"'decode_32k', '--mesh', 'h100x4', '--out', {str(tmp_path)!r}]); "
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')]; sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "jamba-v0.1-52b__decode_32k__h100x4.json")
                     .read_text())
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["sharded_step"]["collectives"] == rec["collectives"]


# -------------------------------------------------- the (2, 2) planner
@pytest.mark.parametrize("arch, shape", D.cell_list())
def test_2x2_records_carry_rank_0s_step(arch, shape):
    """Every cell of ``cell_list()`` on the (2, 2) mesh, each config cut
    to its first block of layers (a train cell at 512 tokens a row), has
    rank 0's step, none refused; its collectives include the gathers and
    reduce-scatters over "data" where the step trains."""
    from repro_torch.configs import SHAPES
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=full.block_period
                              + full.moe.first_dense)
    s = SHAPES[shape]
    if s.kind == "train":
        cfg = dataclasses.replace(cfg, accum_override=0)
        s = ShapeConfig(s.name, 512, 2, "train")
    rec = D.plan(cfg, s, card_mesh("h100x2x2"))
    step = rec["sharded_step"]
    assert "refused" not in step, step.get("refused")
    assert rec["collectives"] == step["collectives"]
    if s.kind == "train":
        assert step["collectives"]["all-gather"]["count"] > 0
        assert step["collectives"]["reduce-scatter"]["count"] > 0
    assert step["predicted_peak_bytes"] == (
        rec["argument_bytes_per_device"] + step["peak_held_bytes"])


def test_2x2_refuses_a_train_batch_data_does_not_split():
    """A train batch of 3 rows on (2, 2) is no longer refused: rank 0
    runs every row's first half of the positions.  Beside the FSDP
    gathers it all-gathers each layer's keys and values over "data"
    (in the forward and in the recompute), whose backward
    reduce-scatters them, so it counts two gathers and one scatter a
    layer more than the batch of 4, whose rows split."""
    cfg = get_smoke("llama3.2-1b")
    rec = D.plan(cfg, ShapeConfig("t", 32, 3, "train"),
                 card_mesh("h100x2x2"))
    rows = D.plan(cfg, ShapeConfig("t", 32, 4, "train"),
                  card_mesh("h100x2x2"))
    step = rec["sharded_step"]
    assert "refused" not in step, step.get("refused")
    assert rec["collectives"] == step["collectives"]
    got, base = step["collectives"], rows["sharded_step"]["collectives"]
    n = cfg.n_layers
    assert got["all-gather"]["count"] == base["all-gather"]["count"] + 2 * n
    assert got["reduce-scatter"]["count"] == (
        base["reduce-scatter"]["count"] + n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_1x4_records_keep_their_collectives(kind):
    """The (1, 4) records of the smoke llama (8/4 heads, B = 4, S = 32)
    keep the collectives they had before "data" could exceed 1: no
    gather or reduce-scatter over "data", the counts pinned by
    ``tests/test_torch_sharded.py`` and ``test_torch_sharded_train.py``."""
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), **R.HEADS)
    rec = D.plan(cfg, ShapeConfig("c", 32, 4, kind), MESH)
    act = 32768.0
    want = {"train": (13.0, 12 * act + 4, 131072.0),
            "prefill": (5.0, 163840.0, 4096.0),
            "decode": (5.0, 5120.0, 4096.0)}[kind]
    got = rec["collectives"]
    assert set(got) == {"all-reduce", "all-gather"}
    assert (got["all-reduce"]["count"], got["all-reduce"]["result_bytes"],
            got["all-gather"]["result_bytes"]) == want

