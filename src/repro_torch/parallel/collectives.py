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
logits.

:class:`ShardedRun` is the ``res`` that ``models/transformer.py`` and
``models/layers.py`` take: the resolver, the process group and the
rank's coordinates on the ("data", "model") mesh.  Whether a product
ends in a collective the layers read from the rank's weights: a width
below the config's (heads, ``d_ff``, experts, ``d_inner``, vocab) is a
block of a split dim, as the resolver's divisibility fallbacks chose it.
The collectives go through ``torch.ops._c10d_functional`` and ``wait_tensor``,
which ``launch/op_cost.py`` counts on the ``meta`` device (under the
``fake`` backend) and on real tensors alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import coords as mesh_coords
from repro_torch.models.transformer import check_shardable
from repro_torch.parallel.sharding import MODEL, Mesh, ShardingResolver


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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``."""
        c = torch.ops._c10d_functional
        return c.wait_tensor(c.all_reduce(x.contiguous(), "sum",
                                          self.group.group_name))

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, rank 0 first.
        A CUDA tensor under gloo goes through host memory: gloo gathers
        no CUDA tensor (four ranks on one card ended with SIGSEGV)."""
        c = torch.ops._c10d_functional
        dev = x.device
        y = x.movedim(dim, 0).contiguous()
        if y.is_cuda and dist.get_backend(self.group) == "gloo":
            y = y.cpu()
        y = c.wait_tensor(c.all_gather_into_tensor(y, self.size,
                                                   self.group.group_name))
        return y.to(dev).movedim(0, dim).contiguous()


def sharded_run(cfg: ModelConfig, mesh: Mesh, *, rank: int = 0,
                group=None) -> ShardedRun:
    """The ``res`` of mesh rank ``rank`` for ``cfg`` (refused by
    ``transformer.check_shardable`` with ``ValueError``): tensor-parallel
    weights, the JAX package's serving resolver (its FSDP variant
    splits nothing more while "model" is the only axis above 1).
    ``group`` spans the "model" axis."""
    check_shardable(cfg, mesh)
    if group is not None and group.size() != mesh.size:
        raise ValueError(f"a group of {group.size()} for a mesh of "
                         f"{mesh.size}")
    return ShardedRun(ShardingResolver(mesh), mesh_coords(mesh, rank), group)
