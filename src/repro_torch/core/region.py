"""Region: the NDRange work-description type (paper's offload geometry).

The paper distinguishes two offload styles — **binary** (a whole program
offloaded once, init -> teardown) and **ROI** (a *region of interest*
re-offloaded repeatedly against persistent state) — and its optimizations
pay 7.5% in the former but 17.4% in the latter.  Expressing that requires
the work geometry to be a first-class API type instead of a flat
``total_work`` integer:

* ``Dim(offset, size, lws)`` — one NDRange dimension: a half-open range
  ``[offset, offset + size)`` with an ``lws`` alignment unit (the local
  work size of that dimension).
* ``Region(dims)`` — 1-D or 2-D NDRange.  1-D regions are the classic
  work-group line the schedulers always carved; 2-D regions describe image
  workloads (rows x cols) and are carved as **row panels**: contiguous
  ``lws``-aligned runs of dim-0 spanning the full dim-1 extent, so every
  scheduler's 1-D carving law applies unchanged along dim 0.

Regions are value types (frozen, hashable).  Sub-regions (the paper's
ROIs) are validated with :meth:`Region.contains` (geometric containment)
and :meth:`Region.aligned_within` (per-dimension lws alignment relative
to the enclosing workload), so an ROI submit can never carve work the
registered buffers do not back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

__all__ = ["Dim", "Region", "as_region"]


@dataclass(frozen=True)
class Dim:
    """One NDRange dimension: ``[offset, offset + size)``, lws-aligned."""
    offset: int
    size: int
    lws: int = 1

    def __post_init__(self):
        if self.offset < 0:
            raise ValueError(f"Dim offset must be >= 0, got {self.offset}")
        if self.size <= 0:
            raise ValueError(f"Dim size must be positive, got {self.size}")
        if self.lws <= 0:
            raise ValueError(f"Dim lws must be positive, got {self.lws}")

    @property
    def end(self) -> int:
        return self.offset + self.size

    def contains(self, other: "Dim") -> bool:
        return self.offset <= other.offset and other.end <= self.end

    def aligned_within(self, outer: "Dim") -> bool:
        """True if this dim starts on an ``outer.lws`` boundary (relative
        to ``outer``) and covers whole lws units — except a final
        remainder, which may stop exactly at ``outer.end``."""
        rel = self.offset - outer.offset
        if rel % outer.lws != 0:
            return False
        return self.size % outer.lws == 0 or self.end == outer.end


@dataclass(frozen=True)
class Region:
    """A 1-D or 2-D NDRange (dim 0 is the carved axis; dim 1, when
    present, is the row width carried whole in every packet)."""
    dims: Tuple[Dim, ...]

    def __post_init__(self):
        dims = tuple(self.dims)
        if not (1 <= len(dims) <= 2):
            raise ValueError(
                f"Region supports 1-D and 2-D NDRanges, got {len(dims)} dims")
        if not all(isinstance(d, Dim) for d in dims):
            raise TypeError("Region dims must be Dim instances")
        object.__setattr__(self, "dims", dims)

    # -- constructors -------------------------------------------------------
    @classmethod
    def line(cls, size: int, lws: int = 1, offset: int = 0) -> "Region":
        """1-D region: ``size`` work-groups from ``offset``."""
        return cls((Dim(offset, size, lws),))

    @classmethod
    def rect(cls, rows: int, cols: int, *,
             lws: Tuple[int, int] = (1, 1),
             offset: Tuple[int, int] = (0, 0)) -> "Region":
        """2-D region: ``rows x cols`` from ``offset`` (row-major)."""
        return cls((Dim(offset[0], rows, lws[0]),
                    Dim(offset[1], cols, lws[1])))

    # -- geometry -----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(d.offset for d in self.dims)

    @property
    def work(self) -> int:
        """Total work-items (product of per-dimension sizes)."""
        w = 1
        for d in self.dims:
            w *= d.size
        return w

    def contains(self, other: "Region") -> bool:
        return (self.ndim == other.ndim
                and all(a.contains(b)
                        for a, b in zip(self.dims, other.dims)))

    def aligned_within(self, outer: "Region") -> bool:
        """Per-dimension lws alignment of this region inside ``outer``."""
        return (self.ndim == outer.ndim
                and all(a.aligned_within(b)
                        for a, b in zip(self.dims, outer.dims)))

    def row_panel(self, rel_offset: int, size: int) -> "Region":
        """The packet geometry: ``size`` dim-0 units starting ``rel_offset``
        units into this region, spanning the full remaining dims."""
        d0 = self.dims[0]
        if rel_offset < 0 or rel_offset + size > d0.size:
            raise ValueError(
                f"row panel [{rel_offset}, {rel_offset + size}) outside "
                f"dim-0 extent [0, {d0.size})")
        return Region((Dim(d0.offset + rel_offset, size, d0.lws),)
                      + self.dims[1:])

    def __repr__(self) -> str:
        spans = "x".join(f"[{d.offset}:{d.end})/{d.lws}" for d in self.dims)
        return f"Region({spans})"


def as_region(work: Union[int, Region], lws: int = 1) -> Region:
    """Normalize the scheduler/Program work argument: a bare int is the
    legacy flat work-group count (1-D region at offset 0)."""
    if isinstance(work, Region):
        return work
    return Region.line(int(work), lws=lws)
