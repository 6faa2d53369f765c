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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import coords as mesh_coords
from repro_torch.models.transformer import check_shardable, check_trainable
from repro_torch.parallel.sharding import (MODEL, Mesh, ShardingResolver,
                                           local_slice)


@dataclass
class ShardedRun:
    """One rank of a model split over the mesh's "model" axis: what the
    sharded model's functions take as ``res``."""
    resolver: ShardingResolver
    coords: Dict[str, int]
    group: Optional[object] = None     # a torch.distributed ProcessGroup

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

    def _reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        c = torch.ops._c10d_functional
        return c.wait_tensor(c.all_reduce(x.contiguous(), op,
                                          self.group.group_name))

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        c = torch.ops._c10d_functional
        dev = x.device
        y = x.movedim(dim, 0).contiguous()
        if y.is_cuda and dist.get_backend(self.group) == "gloo":
            y = y.cpu()
        y = c.wait_tensor(c.all_gather_into_tensor(y, self.size,
                                                   self.group.group_name))
        return y.to(dev).movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``; its gradient passes through."""
        return _Sum.apply(x, self)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x`` (no gradient)."""
        return self._reduce(x, "max")

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
    """The all-reduce that ends a split product: the forward sums, the
    backward passes the (equal) gradient to every rank's part."""

    @staticmethod
    def forward(ctx, x, run):
        return run._reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


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


def sharded_run(cfg: ModelConfig, mesh: Mesh, *, rank: int = 0,
                group=None, train: bool = False) -> ShardedRun:
    """The ``res`` of mesh rank ``rank`` for ``cfg``: tensor-parallel
    weights, the JAX package's serving resolver (its FSDP variant splits
    nothing more while "model" is the only axis above 1), caches split
    by positions where the resolver puts "kv_seq" on the axis.  Refused
    with ``ValueError`` by ``transformer.check_shardable``, or with
    ``train`` by ``transformer.check_trainable``.  ``group`` spans the
    "model" axis."""
    (check_trainable if train else check_shardable)(cfg, mesh)
    if group is not None and group.size() != mesh.size:
        raise ValueError(f"a group of {group.size()} for a mesh of "
                         f"{mesh.size}")
    return ShardedRun(ShardingResolver(mesh), mesh_coords(mesh, rank), group)
