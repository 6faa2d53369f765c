"""Cost model of an eager PyTorch program: the port's counterpart of the
JAX package's ``launch/hlo_cost.py`` (``analyze``: flops, dot_flops,
transcendentals, traffic_bytes) and ``launch/hlo_analysis.py``
(``op_histogram``, ``collective_stats``).

The JAX package walks a compiled module's HLO text; the port has no
compiled module, so :class:`OpCost` is a ``TorchDispatchMode`` that sees
every aten op the program runs, on whatever device, and counts:

* ``dot_flops``: the products' flops by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, ...),
  2 M N K for a matmul; a product over one term (K = 1, an outer
  product) is M N multiplies, as XLA rewrites such a dot;
* ``flops``: the dot flops, plus one a pointwise op's output element and
  one a reduction's input element, as ``hlo_cost`` counts elementwise and
  ``reduce`` ops;
* ``transcendentals``: an element of exp, log, tanh, sqrt, rsqrt, pow,
  sigmoid, silu, softplus, erf, softmax and their kin;
* ``traffic_bytes``: every op's tensor inputs and outputs, each once
  (views, metadata queries and ``empty`` allocations move nothing).  The
  port runs one eager op at a time, unfused, so each op's operands cross
  HBM: this is its traffic model, as post-fusion buffers are the JAX
  package's;
* ``op_histogram``: ops by aten name;
* the peak of the bytes the program allocates and still holds, each
  storage rounded up to the CUDA caching allocator's 512 bytes, from the
  storages the ops return (an output that aliases no input is a new
  allocation; a storage is freed when its last tensor goes, which a weak
  reference observes).

The hand-written kernels have no aten op.  A wrapper given ``meta``
tensors records the kernel's least operations and bytes in its module's
``meta_cost`` (``kernels.build.tally``); the mode adds the calls made
while it is active.  On the CPU the wrappers run their plain versions,
whose aten ops the mode counts as any others.

No loop-trip correction is needed: eager code runs every iteration, so a
layer loop or a gradient-accumulation loop is counted as often as it
runs.

Collectives: a rank of a sharded model (``parallel/collectives.py``)
calls ``torch.ops._c10d_functional``'s ops, which the mode sees on real
tensors and on ``meta`` ones under the ``fake`` backend alike.  Each is
counted by kind (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``) with its result bytes and its ring wire bytes, the
formulas of the JAX package's ``hlo_analysis._wire_bytes`` over the
process group's size; ``wait_tensor`` moves nothing.  A program that
runs none has ``{}`` and 0 wire bytes.
"""
from __future__ import annotations

import importlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the CUDA caching allocator's block granularity (bytes)
ALLOC_ROUND = 512

# the wrappers whose meta calls the mode adds (each keeps ``meta_cost``)
KERNEL_MODULES = ("repro_torch.kernels.flash_attention.kernel",
                  "repro_torch.kernels.flash_decode.kernel",
                  "repro_torch.kernels.mamba_scan.kernel")

_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sqrt",
    "rsqrt", "pow", "sin", "cos", "sigmoid", "silu", "silu_backward",
    "softplus", "softplus_backward", "erf", "gelu", "_softmax",
    "_log_softmax", "logsumexp", "logaddexp"}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "var", "std", "norm",
    "linalg_vector_norm", "topk", "sort", "argmax", "argmin", "any", "all"}
# products by the argument whose last dim is the contraction
_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "wait_tensor", "_wrap_tensor_autograd"}
# ``_c10d_functional`` ops by kind (their in-place and coalesced forms too)
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def rounded_bytes(nbytes: int) -> int:
    """``nbytes`` as the CUDA caching allocator rounds a request."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or result (lists, tuples, dicts
    of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Ring estimate of the bytes a device sends for one collective of
    ``out_bytes`` result bytes over ``group`` devices (the JAX package's
    ``hlo_analysis._wire_bytes``)."""
    g = max(group, 2)
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def _group_size(args) -> int:
    """The size of the process group named by a ``_c10d_functional`` op's
    last string argument."""
    from torch.distributed import distributed_c10d as c10d
    name = next(a for a in reversed(args) if isinstance(a, str))
    return c10d._resolve_process_group(name).size()


def _kernel_tallies() -> Dict[str, Dict[str, float]]:
    out = {}
    for path in KERNEL_MODULES:
        for name, t in importlib.import_module(path).meta_cost.items():
            out[name] = dict(t)
    return out


class OpCost(TorchDispatchMode):
    """Count what the ops run under it cost (the module's docstring);
    :meth:`summary` gives the totals once it has exited."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.transcendentals = 0.0
        self.traffic_bytes = 0.0
        self.hist: Dict[str, int] = defaultdict(int)
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.current = 0          # allocated since entry, freed or not
        self.peak = 0             # most held at once since entry
        self._k0: Dict[str, Dict[str, float]] = {}
        self._depth = 0           # re-entered to decompose composite ops
        self._t0 = 0.0
        self.seconds = 0.0        # wall time under the mode

    def __enter__(self):
        if not self._depth:
            self._k0 = _kernel_tallies()
            self._t0 = time.perf_counter()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        self.seconds = time.perf_counter() - self._t0
        k1 = _kernel_tallies()
        for name, t in k1.items():
            t0 = self._k0.get(name, {})
            d = {k: v - t0.get(k, 0) for k, v in t.items()}
            if not d["calls"]:
                continue
            self.kernels[name] = d
            self.flops += d["flops"]
            self.dot_flops += d["dot_flops"]
            self.transcendentals += d["transcendentals"]
            self.traffic_bytes += d["bytes"]
            self.hist[f"kernel.{name}"] += int(d["calls"])
        return out

    # ------------------------------------------------------------------
    def held(self) -> int:
        """Bytes allocated under the mode and still held (rounded)."""
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.current -= self.live.pop(key)[1]
        return self.current

    def _track(self, ins: List[torch.Tensor], outs: List[torch.Tensor]):
        seen = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        for t in outs:
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata in seen:
                continue
            seen.add(ref.cdata)
            old = self.live.get(ref.cdata)
            if old is not None and not old[0].expired():
                continue
            if old is not None:
                self.current -= old[1]
            n = rounded_bytes(t.untyped_storage().nbytes())
            self.live[ref.cdata] = (ref, n)
            self.current += n
        if self.current > self.peak:
            self.peak = max(self.peak, self.held())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_counter.flop_registry:
            # a composite op (``matmul``, ``to``, ``pad``: seen whole under
            # inference mode) is counted as the ops it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.hist[f"{func.namespace}.{name}"] += 1
        if func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = (_COLLECTIVES.get(name.rstrip("_").removesuffix("_coalesced"))
                if func.namespace == "_c10d_functional" else None)
        if kind:
            nbytes = sum(map(_nbytes, outs))
            s = self.collectives.setdefault(
                kind, {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0})
            s["count"] += 1
            s["result_bytes"] += nbytes
            s["wire_bytes"] += wire_bytes(kind, nbytes, _group_size(args))
        self._track(ins, outs)
        if name not in _NO_TRAFFIC:
            self.traffic_bytes += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, outs))
        packet = func.overloadpacket
        if packet in flop_counter.flop_registry:
            if name in _PRODUCTS and ins[_PRODUCTS[name]].shape[-1] == 1:
                # one term a sum: an outer product, a multiply an element
                self.flops += outs[0].numel()
            else:
                f = flop_counter.flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
                self.dot_flops += f
                self.flops += f
        elif name in _REDUCTION and ins:
            self.flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags and outs:
            self.flops += sum(t.numel() for t in outs)
        if name in _TRANSCENDENTAL and outs:
            n = ins[0].numel() if name == "logsumexp" else outs[0].numel()
            self.transcendentals += n
        return out

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        """The totals, under ``hlo_cost.analyze``'s names where they
        mean the same."""
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "transcendentals": self.transcendentals,
                "traffic_bytes": self.traffic_bytes,
                "collectives": collective_stats(self),
                "collective_wire_bytes": sum(
                    c["wire_bytes"] for c in self.collectives.values()),
                "kernels": self.kernels,
                "peak_held_bytes": self.peak}

    def op_histogram(self, top: int = 25) -> List[Tuple[str, int]]:
        return op_histogram(self.hist, top)


def op_histogram(hist: Dict[str, int], top: int = 25
                 ) -> List[Tuple[str, int]]:
    """The ``top`` most run ops, most first."""
    return sorted(hist.items(), key=lambda kv: -kv[1])[:top]


def collective_stats(cost: Optional[OpCost] = None
                     ) -> Dict[str, Dict[str, float]]:
    """The collectives ``cost`` counted, by kind: count, result bytes and
    wire bytes (none without one, or on one card)."""
    return {} if cost is None else {k: dict(v) for k, v in
                                    cost.collectives.items()}


def analyze(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCost`; its totals
    (``summary``) with the histogram, as ``hlo_cost.analyze`` gives a
    compiled module's."""
    with OpCost() as oc:
        fn(*args, **kwargs)
    return dict(oc.summary(), op_histogram=oc.op_histogram())
