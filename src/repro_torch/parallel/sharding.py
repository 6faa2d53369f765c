"""Logical-axis sharding resolver, the JAX package's
``parallel/sharding.py``.

Every parameter, cache entry and input is annotated with a tuple of
*logical* axis names (``("vocab", "d_model")`` ...): the port's
``transformer.param_axes`` / ``cache_axes`` and ``launch/specs.py`` give
them.  The resolver maps logical names to mesh axes through an ordered
rule table with **divisibility fallbacks**: a rule is only taken if the
mesh-axis product divides the dim size and none of its mesh axes is
already used by another dim of the same tensor.  So one rule table
serves every config: internvl2's 14 heads or 151655 vocab fall through
to the next candidate (or replication) instead of failing.

FSDP: for parameters the largest still-unsharded eligible dim is also
sharded over the ``data`` (and ``pod``) axes, ZeRO-3 style, when the
resolver is built with ``fsdp=True``.

The rules, priorities and passes are the JAX package's, name for name;
what differs is the mesh, here a plain :class:`Mesh` of axis names and
sizes (no device objects), and the spec, a tuple with the entries of the
JAX package's ``PartitionSpec``.  :func:`shard_shape` gives a tensor's
per-device shape under a spec, as ``NamedSharding.shard_shape`` does, and
:func:`local_slice` a device's block of it, as ``NamedSharding`` lays the
shards out on a mesh whose devices are numbered row-major.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

# The mesh axis that sharded serving splits weights over, and the one
# that splits the batch (and, under FSDP, the weights' blocks again)
MODEL = "model"
DATA = "data"

# Candidate mesh-axis tuples per logical axis, in preference order.  An empty
# tuple means "replicate" and always succeeds.
Rules = Dict[str, List[Tuple[str, ...]]]
# One entry a dim: None (replicated), a mesh axis, or a tuple of mesh axes
Spec = Tuple[Optional[object], ...]
Logical = Tuple[Optional[str], ...]

# Priority: lower = resolved first (gets first pick of mesh axes).
_PRIORITY = {
    "batch": 0,
    "experts": 1,
    "heads": 2,
    "d_ff": 2,
    "d_inner": 2,
    "vocab": 3,
    "kv_heads": 4,
    "kv_seq": 5,
    "seq": 6,
    "d_model": 8,       # last-resort TP dim (row-parallel fallback)
    "capacity": 7,
}

DEFAULT_RULES: Rules = {
    "batch":    [("pod", "data"), ("data",)],
    "experts":  [("model",)],
    "heads":    [("model",)],
    "kv_heads": [("model",)],
    "d_ff":     [("model",)],
    "d_inner":  [("model",)],
    "vocab":    [("model",)],
    "kv_seq":   [("model",)],       # GQA caches: few kv heads -> shard time
    "seq":      [("data",)],        # SP once batch can't use it (e.g. batch=1)
    "capacity": [("pod", "data"), ("data",)],  # MoE (E,C,d) buffers
    "d_model":  [],                 # replicated by default (see FSDP below)
}

# Param dims eligible for the FSDP (ZeRO-3) extra shard, tried in this order.
_FSDP_AXES = [("data",), ("pod", "data"), ("pod",)]
_FSDP_ELIGIBLE = ("d_model", "d_ff", "d_inner", "vocab", "experts_inner",
                  "heads_flat", "kv_lora", "conv", "dt_rank", "d_state_in")


@dataclass(frozen=True)
class Mesh:
    """A device mesh as the resolver sees it: axis names and sizes.  The
    product is the number of devices; :func:`repro_torch.launch.mesh`
    builds the ones the port plans for."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or any(
                n < 1 for n in self.shape):
            raise ValueError(f"mesh {self.axis_names} x {self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def tag(self) -> str:
        return "x".join(str(s) for s in self.shape)


def _axes_size(mesh_shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return n


@dataclass
class ShardingResolver:
    mesh: Mesh
    rules: Rules = field(default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = False              # extra data-axis shard on params

    def _mesh_shape(self) -> Dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.mesh.shape))

    # ------------------------------------------------------------------
    def spec(self, logical: Sequence[Optional[str]],
             shape: Sequence[int], *, param: bool = False) -> Spec:
        """Resolve one tensor's logical axes to a spec: a tuple with the
        entries of the JAX package's ``PartitionSpec``."""
        ms = self._mesh_shape()
        n = len(logical)
        if n != len(shape):
            raise ValueError(f"logical axes {tuple(logical)} do not fit "
                             f"shape {tuple(shape)}")
        assign: List[Optional[Tuple[str, ...]]] = [None] * n
        used: set = set()
        order = sorted(range(n),
                       key=lambda i: _PRIORITY.get(logical[i] or "", 99))
        for i in order:
            name = logical[i]
            if name is None:
                continue
            for cand in self.rules.get(name, []):
                if not cand:
                    break
                if any(a in used or a not in ms for a in cand):
                    continue
                if shape[i] % _axes_size(ms, cand) != 0:
                    continue
                assign[i] = cand
                used.update(cand)
                break
        if param and self.fsdp:
            self._apply_fsdp(logical, shape, assign, used, ms)
        return tuple(a if a is None else (a[0] if len(a) == 1 else a)
                     for a in assign)

    def _apply_fsdp(self, logical, shape, assign, used, ms) -> None:
        # Shard the largest eligible unsharded dim over the data axes.
        cands = [i for i in range(len(shape))
                 if assign[i] is None and (logical[i] in _FSDP_ELIGIBLE
                                           or logical[i] == "d_model")]
        cands.sort(key=lambda i: -shape[i])
        for i in cands:
            for axes in _FSDP_AXES:
                if any(a in used or a not in ms for a in axes):
                    continue
                if shape[i] % _axes_size(ms, axes) != 0:
                    continue
                assign[i] = axes
                used.update(axes)
                return

    # ------------------------------------------------------------------
    def tree_specs(self, logical: Mapping[str, Logical],
                   shapes: Mapping[str, Sequence[int]], *,
                   param: bool = False) -> Dict[str, Spec]:
        """``spec`` over two dicts keyed alike (a module's
        ``named_parameters()`` names, say): logical axes and shapes."""
        return {k: self.spec(ax, shapes[k], param=param)
                for k, ax in logical.items()}


def shard_shape(mesh: Mesh, spec: Spec, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """A tensor's per-device shape under ``spec`` (every sharded dim
    divides by its mesh axes' product, as the resolver chooses them)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        n = 1 if ax is None else _axes_size(
            sizes, (ax,) if isinstance(ax, str) else tuple(ax))
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


def local_slice(mesh: Mesh, spec: Spec, shape: Sequence[int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the device at ``coords``
    (mesh axis -> index) holds under ``spec``: each sharded dim's
    contiguous ``shard_shape`` block, numbered over the dim's mesh axes
    in their order (the first the slowest), as ``NamedSharding`` places
    shards on a row-major mesh."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    local = shard_shape(mesh, spec, shape)
    out = []
    for n, ax in zip(local, tuple(spec) + (None,) * (len(shape)
                                                    - len(spec))):
        idx = 0
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else tuple(ax)):
            idx = idx * sizes[a] + coords[a]
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def constrain(x: torch.Tensor, resolver: Optional[ShardingResolver],
              logical: Logical) -> torch.Tensor:
    """The identity.  The JAX package tells XLA's SPMD partitioner where
    an activation lies (``with_sharding_constraint``) and the partitioner
    inserts the collectives; the port runs each rank's shard as plain
    tensors and calls its collectives itself, at the products whose
    contraction the weights split (``parallel/collectives.py``), so there
    is nothing to tell."""
    del resolver, logical
    return x


def shapes_of(tensors: Mapping[str, torch.Tensor]
              ) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(t.shape) for k, t in tensors.items()}
