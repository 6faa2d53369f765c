"""A rank's view of a sharded model, and the collectives that join the
ranks' partial results.

The JAX package has no counterpart module: it hands its resolver to the
model, places activations with ``constrain``, and XLA's SPMD partitioner
inserts the collectives.  The port runs each rank's block of every
weight as plain tensors (so the hand-written kernels run unchanged at the
per-rank shapes) and calls the collectives itself where a product's
contraction runs over a split dim: an all-reduce after ``wo``,
``w_down``, the experts' combine, Mamba's ``x_proj`` and ``out_proj``
and the vocab-split embedding, and an all-gather of the vocab-split
logits.  A cache that the resolver splits by positions (its "kv_seq" on
the "model" axis: every MLA cache, and GQA's whose kv heads do not
divide over the axis) leaves each rank a stretch of positions
(:meth:`ShardedRun.kv_stretch`); a decode step's attention is then each
rank's partial over its live rows with each head's log-sum-exp, joined
by :meth:`ShardedRun.combine_lse` (an all-reduce of the max, one of the
weighted sums), MLA's after an all-gather of its latent queries over
heads.

:class:`ShardedRun` is the ``res`` that ``models/transformer.py`` and
``models/layers.py`` take: the resolver, the process group and the
rank's coordinates on the ("data", "model") mesh.  Whether a product
ends in a collective the layers read from the rank's weights: a width
below the config's (heads, ``d_ff``, experts, ``d_inner``, vocab) is a
block of a split dim, as the resolver's divisibility fallbacks chose it.
The collectives go through ``torch.ops._c10d_functional`` and ``wait_tensor``,
which ``launch/op_cost.py`` counts on the ``meta`` device (under the
``fake`` backend) and on real tensors alike.

Training: the collectives carry gradients.  The all-reduce that ends a
split product sums in the forward and passes the gradient through (every
rank holds the same gradient of the sum); :meth:`ShardedRun.enter` is the
identity in the forward and all-reduces the gradient in the backward: it
marks where a tensor that is equal on every rank (an activation, a norm
or the router's gates) meets the rank's block, so that the gradient of
the equal tensor adds every rank's part.  The vocab gather's backward
takes the rank's slice of the gradient of the gathered logits, which
every rank holds whole.  Each backward collective goes through
``_c10d_functional`` too, so the planner counts it.

A mesh whose "data" axis exceeds 1 (the JAX package's FSDP, ZeRO-3
layout): each rank takes its rows of the batch (:meth:`ShardedRun.rows`)
and, under the FSDP resolver (training, and prefill of a
``serve_2d_weights`` config), holds the block of every weight that the
resolver splits over "data" too.  :meth:`ShardedRun.gather_blocks`
all-gathers a layer's blocks over "data" before use (one collective a
dtype) and reduce-scatters their gradients back (sums over "data", the
rank keeping its block's); :meth:`ShardedRun.token_sum` sums a statistic
over the ranks that hold other tokens (the loss, the MoE layers'
counts), the gradient passing through; :meth:`ShardedRun.sum_over_tokens`
sums the gradients of the weights "data" leaves whole, in one
all-reduce.  The gradient convention
is the one above: every rank's loss is the whole batch's, and each
collective's backward gives a rank the gradient of its own part.  The
"model" collectives run on the rank's "model" group (the ranks of its
"data" coordinate), the "data" ones on its "data" group (the ranks of
its "model" coordinate).  With "data" 1 there is no "data" group and
every path runs as on the (1, n) mesh.

A "pod" axis above 1 (the JAX package's multi-pod mesh, ("pod", "data",
"model")): the rank's "pod" group holds the ranks of its ("data",
"model") coordinates, and where both exceed 1 a "batch" group holds
those of its "model" coordinate.  The resolver puts "batch" on ("pod",
"data") where that divides the rows, else on "data" alone, the rows
then replicated over "pod".  FSDP takes "data" first, so no weight is
split over "pod": with "data" 1 every weight is whole over "pod".

Which ranks hold distinct tokens of a batch is the batch's
:class:`Tokens` (:meth:`ShardedRun.for_batch`, from the resolver's spec
of the tokens' ("batch", "seq")): the rank's rows, its stretch of
positions where the JAX rule ``"seq": [("data",)]`` puts the positions
on "data" (a microbatch whose rows "data" does not divide: sequence
parallelism), and the mesh axes over which the tokens differ.  The
sums of a statistic (the loss, the MoE layers' counts) and of the
gradients of the weights split over no such axis run over exactly those
axes (:meth:`ShardedRun.token_sum`, :meth:`ShardedRun.sum_over_tokens`):
rows replicated over an axis are counted once.  Under a stretch the
layers see the rank's positions only: attention all-gathers the keys
and values (MLA its latent rows) over "data" up to the stretch's end
(:meth:`ShardedRun.seq_gather`, whose backward reduce-scatters), Mamba
takes its conv's halo and its scan's initial state from the earlier
stretches, and the capacity dispatch counts the earlier stretches'
slots (:meth:`ShardedRun.gather_counts`).  A ``res`` without
:class:`Tokens` (serving, and a step handed the rank's rows) takes the
rows split over the batch axes and no stretch.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import coords as mesh_coords
from repro_torch.models.transformer import check_shardable, check_trainable
from repro_torch.parallel.sharding import (DATA, MODEL, POD, Mesh,
                                           ShardingResolver, local_slice)


@dataclass(frozen=True)
class Tokens:
    """Where a batch's tokens lie on a rank (:meth:`ShardedRun.for_batch`):
    ``rows`` its rows of the whole batch, ``stretch`` (first position,
    length) of each row's positions where "seq" is split over "data"
    (None: every position), ``axes`` the mesh axes (of size above 1)
    whose ranks hold distinct tokens."""
    rows: slice
    stretch: Optional[Tuple[int, int]]
    axes: Tuple[str, ...]


@dataclass
class ShardedRun:
    """One rank of a model split over the ("pod", "data", "model") mesh:
    what the sharded model's functions take as ``res``.  ``group`` spans
    the rank's "model" axis, ``data_group`` its "data" axis (None while
    "data" is 1), ``pod_group`` its "pod" axis (None while "pod" is 1)
    and ``batch_group`` its ("pod", "data") axes (None unless both
    exceed 1); ``tokens`` the layout of a batch (:meth:`for_batch`)."""
    resolver: ShardingResolver
    coords: Dict[str, int]
    group: Optional[object] = None     # a torch.distributed ProcessGroup
    data_group: Optional[object] = None
    pod_group: Optional[object] = None
    batch_group: Optional[object] = None
    tokens: Optional[Tokens] = None

    @property
    def mesh(self) -> Mesh:
        return self.resolver.mesh

    @property
    def rank(self) -> int:
        """The rank's index on the "model" axis."""
        return self.coords[MODEL]

    @property
    def size(self) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.shape))[MODEL]

    @property
    def data_rank(self) -> int:
        """The rank's index on the "data" axis."""
        return self.coords.get(DATA, 0)

    @property
    def data_size(self) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.shape)).get(DATA, 1)

    @property
    def pod_size(self) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.shape)).get(POD, 1)

    def for_batch(self, n_rows: int, n_pos: int) -> "ShardedRun":
        """This rank with the :class:`Tokens` of a batch of ``n_rows``
        rows of ``n_pos`` positions, as the resolver lays out the tokens'
        ("batch", "seq"): the rows over ("pod", "data") or "data", else
        the positions over "data", else replicated."""
        shape = (n_rows, n_pos)
        spec = self.resolver.spec(("batch", "seq"), shape)
        rows, pos = local_slice(self.mesh, spec, shape, self.coords)
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        axes = tuple(a for ax in spec if ax is not None
                     for a in ((ax,) if isinstance(ax, str) else ax)
                     if sizes[a] > 1)
        stretch = (None if spec[1] is None
                   else (pos.start, pos.stop - pos.start))
        # a shallow copy: a subclass and its own attributes are kept
        run = copy.copy(self)
        run.tokens = Tokens(rows, stretch, axes)
        return run

    @property
    def stretch(self) -> Optional[Tuple[int, int]]:
        """The rank's (first position, length) of a batch whose positions
        are split over "data", else None."""
        return None if self.tokens is None else self.tokens.stretch

    def token_group(self):
        """The group of the ranks whose tokens differ from this rank's
        and whose "model" coordinate is its own; None where no other rank
        holds other tokens.  Without :class:`Tokens`, the "data" group
        (the rows split over "data")."""
        if self.tokens is None:
            return self.data_group
        axes = set(self.tokens.axes)
        if axes == {DATA}:
            return self.data_group
        if axes == {POD}:
            return self.pod_group
        if axes == {POD, DATA}:
            return self.batch_group
        return None

    def _reduce(self, x: torch.Tensor, op: str = "sum",
                group=None) -> torch.Tensor:
        c = torch.ops._c10d_functional
        group = group or self.group
        return c.wait_tensor(c.all_reduce(x.contiguous(), op,
                                          group.group_name))

    def _host(self, y: torch.Tensor, group) -> torch.Tensor:
        """``y``, through host memory where gloo would take it on the
        card."""
        if y.is_cuda and dist.get_backend(group) == "gloo":
            return y.cpu()
        return y

    def _gather(self, x: torch.Tensor, dim: int,
                group=None) -> torch.Tensor:
        c = torch.ops._c10d_functional
        group = group or self.group
        dev = x.device
        y = self._host(x.movedim(dim, 0).contiguous(), group)
        y = c.wait_tensor(c.all_gather_into_tensor(y, group.size(),
                                                   group.group_name))
        return y.to(dev).movedim(0, dim).contiguous()

    def _scatter(self, x: torch.Tensor, group) -> torch.Tensor:
        """The sum over ``group`` of every rank's flat ``x``, of which
        the rank keeps its block (the i-th of ``group.size()``)."""
        c = torch.ops._c10d_functional
        dev = x.device
        y = c.wait_tensor(c.reduce_scatter_tensor(
            self._host(x.contiguous(), group), "sum", group.size(),
            group.group_name))
        return y.to(dev)

    def rows(self, n: int) -> slice:
        """The rank's rows of a batch of ``n``: its block where the
        resolver splits "batch" over "data", else every row (the batch
        is then replicated over "data")."""
        spec = self.resolver.spec(("batch",), (n,))
        return local_slice(self.mesh, spec, (n,), self.coords)[0]

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks that hold distinct tokens of
        the batch (their "model" coordinate the rank's): over "data" where
        the rows or the positions split over it, over "pod" (and "data")
        where the rows split over it, over none where they are
        replicated.  Its gradient passes through to each rank's part."""
        group = self.token_group()
        return x if group is None else _Sum.apply(x, self, group)

    def gather_blocks(self, blocks: Sequence[torch.Tensor],
                      dims: Sequence[int]) -> List[torch.Tensor]:
        """Each of ``blocks`` (a rank's FSDP blocks, split over "data"
        along ``dims``) made whole over "data": one all-gather a dtype,
        whose backward reduce-scatters the gradients back to the rank's
        blocks (their sums over "data"), or, where every "data" rank holds
        the same tokens, takes the rank's block of its own gradient."""
        sums = self.tokens is None or DATA in self.tokens.axes
        return list(_GatherBlocks.apply(self, tuple(dims), sums, *blocks))

    @torch.no_grad()
    def sum_over(self, grads: Sequence[torch.Tensor],
                 group) -> List[torch.Tensor]:
        """Each of ``grads`` summed over ``group``, in one float32
        all-reduce; each comes back in its own dtype."""
        if not grads or group is None:
            return list(grads)
        flat = self._reduce(torch.cat([g.reshape(-1).float()
                                       for g in grads]), group=group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return out

    def sum_over_tokens(self, grads: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Each of ``grads`` (of weights split over no axis that splits
        the tokens) summed over the ranks that hold distinct tokens
        (:meth:`token_sum`'s), in one float32 all-reduce."""
        return self.sum_over(grads, self.token_group())

    def seq_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every "data" rank's ``x`` concatenated along ``dim``, rank 0
        first (the stretches of a split batch in order); the backward
        reduce-scatters: each rank's part gets the sum of every rank's
        gradient of it."""
        return _SeqGather.apply(x, self, dim)

    def gather_counts(self, counts: torch.Tensor
                      ) -> Tuple[torch.Tensor, int]:
        """The int32 ``counts`` of every rank that holds other tokens of
        the batch (:meth:`token_group`), stacked in the order of their
        tokens (the rows' and stretches' order), and this rank's index
        among them (no gradient)."""
        g = self.token_group()
        if g is None:
            return counts[None], 0
        c = torch.ops._c10d_functional
        y = self._host(counts.contiguous(), g)
        y = c.wait_tensor(c.all_gather_into_tensor(y, g.size(),
                                                   g.group_name))
        axes = (DATA,) if self.tokens is None else self.tokens.axes
        i = 0
        for a in (POD, DATA):      # row-major, as the rows are numbered
            if a in axes:
                i = i * dict(zip(self.mesh.axis_names,
                                 self.mesh.shape))[a] + self.coords[a]
        return y.to(counts.device).view((g.size(),) + counts.shape), i

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``; its gradient passes through."""
        return _Sum.apply(x, self, None)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x`` (no gradient)."""
        return self._reduce(x, "max")

    def max_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over every rank of the mesh: over
        "model", then over "data" (no gradient)."""
        x = self.all_reduce_max(x)
        if self.data_group is not None:
            x = self._reduce(x, "max", self.data_group)
        return x

    def kv_stretch(self, axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Optional[Tuple[int, int]]:
        """For a cache entry of logical ``axes`` (one of them "kv_seq")
        and whole ``shape``: (the rank's first position, its stretch's
        length) where the resolver splits the positions over the mesh,
        None where every rank holds them all."""
        spec = self.resolver.spec(axes, shape)
        i = list(axes).index("kv_seq")
        if spec[i] is None:
            return None
        sl = local_slice(self.mesh, spec, shape, self.coords)[i]
        return sl.start, sl.stop - sl.start

    def combine_lse(self, o: torch.Tensor, lse: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Attention over a cache split by positions, from every rank's
        partial: ``o`` (..., D) float32 over the rank's live rows and
        ``lse`` (...) float32, each row's log-sum-exp of its scores (-inf
        where the rank has no live row, whose weight is then exactly 0).
        Two collectives: the max of the log-sum-exps, then one sum of
        ``o`` and the weights packed together.  Returns the softmax-
        weighted whole, in ``dtype`` (float32 when None).  Serving only:
        no gradient."""
        m = self.all_reduce_max(lse)
        w = torch.exp(lse - m)[..., None]
        tot = self._reduce(torch.cat([o * w, w], dim=-1))
        out = tot[..., :-1] / tot[..., -1:]
        return out if dtype is None else out.to(dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, equal on every rank, where it meets the rank's block:
        the identity, whose backward sums the ranks' gradients."""
        return _Enter.apply(x, self)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, rank 0 first;
        the backward takes the rank's slice.  A CUDA tensor under gloo
        goes through host memory: gloo gathers no CUDA tensor (four ranks
        on one card ended with SIGSEGV)."""
        return _Gather.apply(x, self, dim)


class _Sum(torch.autograd.Function):
    """The all-reduce that ends a split product (or sums over "data"):
    the forward sums, the backward passes the (equal) gradient to every
    rank's part."""

    @staticmethod
    def forward(ctx, x, run, group):
        return run._reduce(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity where an equal-on-every-rank tensor meets the rank's
    block; the backward all-reduces the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, run):
        ctx.run = run
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.run._reduce(g), None


class _Gather(torch.autograd.Function):
    """The vocab gather: the backward keeps the rank's slice of the
    gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, run, dim):
        ctx.rank, ctx.dim, ctx.n = run.rank, dim, x.shape[dim]
        return run._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _SeqGather(torch.autograd.Function):
    """The stretches' gather over "data": the forward all-gathers, the
    backward reduce-scatters the gradient to the rank's part."""

    @staticmethod
    def forward(ctx, x, run, dim):
        ctx.run, ctx.dim = run, dim
        return run._gather(x, dim, run.data_group)

    @staticmethod
    def backward(ctx, g):
        run, dim = ctx.run, ctx.dim
        n = run.data_size
        moved = g.movedim(dim, 0).contiguous()
        part = run._scatter(moved.reshape(-1), run.data_group)
        part = part.view((moved.shape[0] // n,) + moved.shape[1:])
        return part.movedim(0, dim), None, None


class _GatherBlocks(torch.autograd.Function):
    """The FSDP gather: the forward all-gathers the blocks over "data"
    (packed flat, one collective a dtype), the backward reduce-scatters
    the whole gradients (packed alike) to the rank's blocks, or with
    ``sums`` False (every "data" rank's gradient the same) takes the
    rank's blocks of them."""

    @staticmethod
    def forward(ctx, run, dims, sums, *blocks):
        ctx.run, ctx.dims, ctx.sums = run, dims, sums
        ctx.shapes = [b.shape for b in blocks]
        group, n = run.data_group, run.data_size
        out: List[Optional[torch.Tensor]] = [None] * len(blocks)
        for idx in _by_dtype(blocks):
            moved = [blocks[i].movedim(dims[i], 0) for i in idx]
            flat = torch.cat([m.reshape(-1) for m in moved])
            y = run._gather(flat, 0, group).view(n, -1)
            at = 0
            for i, m in zip(idx, moved):
                k = m.numel()
                whole = y[:, at:at + k].reshape((n * m.shape[0],)
                                                + m.shape[1:])
                out[i] = whole.movedim(0, dims[i]).contiguous()
                at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        run, dims, n = ctx.run, ctx.dims, ctx.run.data_size
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        if not ctx.sums:
            r = run.data_rank
            return (None, None, None) + tuple(
                g.movedim(d, 0).chunk(n)[r].movedim(0, d)
                for g, d in zip(grads, dims))
        for idx in _by_dtype(grads):
            # rank r's segment: every tensor's r-th block, in order
            parts = [grads[i].movedim(dims[i], 0).chunk(n) for i in idx]
            flat = torch.cat([p[r].reshape(-1) for r in range(n)
                              for p in parts])
            y = run._scatter(flat, run.data_group)
            at = 0
            for i in idx:
                s = ctx.shapes[i]
                k = s.numel()
                moved = (s[dims[i]],) + s[:dims[i]] + s[dims[i] + 1:]
                out[i] = y[at:at + k].view(moved).movedim(0, dims[i])
                at += k
        return (None, None, None) + tuple(out)


def _by_dtype(tensors) -> List[List[int]]:
    """The indices of ``tensors``, grouped by dtype in first-seen order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _axis_groups(mesh: Mesh, coords: Dict[str, int], group,
                 varying: Sequence[Tuple[str, ...]]):
    """For each tuple of mesh axes in ``varying``, the rank's group of the
    ranks that differ from it in those axes only, made from ``group``
    (the mesh's ranks, row-major) by ``dist.new_group``: every rank
    makes every group, in the same order, and keeps its own."""
    ranks = dist.get_process_group_ranks(group)
    mine = []
    for axes in varying:
        fixed = [a for a in mesh.axis_names if a not in axes]
        members: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(mesh.size):
            c = mesh_coords(mesh, r)
            members.setdefault(tuple(c[a] for a in fixed), []).append(r)
        own = tuple(coords[a] for a in fixed)
        for key, rs in members.items():
            g = dist.new_group([ranks[r] for r in rs])
            if key == own:
                mine.append(g)
    return mine


def sharded_run(cfg: ModelConfig, mesh: Mesh, *, rank: int = 0,
                group=None, train: bool = False,
                prefill: bool = False) -> ShardedRun:
    """The ``res`` of mesh rank ``rank`` for ``cfg``: the JAX package's
    resolver of the run, FSDP for training (``train``) and for prefill
    of a ``serve_2d_weights`` config (``prefill``), tensor-parallel
    weights else; caches split by positions where the resolver puts
    "kv_seq" on the "model" axis, by rows where it puts "batch" on
    "data".  Refused with ``ValueError`` by
    ``transformer.check_shardable``, or with ``train`` by
    ``transformer.check_trainable``.  ``group`` spans the mesh (its
    ranks row-major); where "data" exceeds 1 the rank's "model" and
    "data" groups are made from it, on every rank together."""
    (check_trainable if train else check_shardable)(cfg, mesh)
    if group is not None and group.size() != mesh.size:
        raise ValueError(f"a group of {group.size()} for a mesh of "
                         f"{mesh.size}")
    fsdp = train or (prefill and cfg.serve_2d_weights)
    coords = mesh_coords(mesh, rank)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    n_data, n_pod = sizes.get(DATA, 1), sizes.get(POD, 1)
    groups = dict(group=group, data_group=None, pod_group=None,
                  batch_group=None)
    if group is not None and (n_data > 1 or n_pod > 1):
        varying = {"group": (MODEL,)}
        if n_data > 1:
            varying["data_group"] = (DATA,)
        if n_pod > 1:
            varying["pod_group"] = (POD,)
        if n_data > 1 and n_pod > 1:
            varying["batch_group"] = (POD, DATA)
        groups.update(zip(varying, _axis_groups(mesh, coords, group,
                                                list(varying.values()))))
    return ShardedRun(ShardingResolver(mesh, fsdp=fsdp), coords, **groups)
