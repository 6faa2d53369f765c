"""Heterogeneity-aware data-parallel training (the paper's co-execution as
a first-class training-framework feature), the JAX package's
``core/hetero_dp.py`` on PyTorch.

Each training step is a co-execution of one global batch submitted to an
``EngineSession``: the batch's row range is the work queue (1 work-group =
``lws`` rows = the minimum microbatch), device groups pull row-range packets
HGuided-style in proportion to their EWMA-measured throughput, and gradients
are combined weighted by the rows each group actually processed (the
session's ``collect`` hook replaces array output assembly).  Consequences,
by construction:

  * straggler mitigation — a slow/throttled group takes fewer packets and
    everyone finishes the step together (the paper's balance ~= 1);
  * fault tolerance — a group that dies mid-step has its in-flight packet
    requeued; surviving groups absorb it; the step completes with the FULL
    global batch (exactly-once semantics per row range);
  * elastic scaling — groups can be added/removed between steps; powers
    renormalize automatically (HGuidedOpt's online estimation);
  * optional int8 error-feedback compression on the gradient combine.

The trainer's session keeps per-group state across steps
(``reset_device_stats=False``): throughput EWMAs carry into the next step's
profiles and a failed group stays excluded until removed/replaced.

Groups run their packets in threads of their own and share the
parameters' storage, so a packet's gradients come from
``torch.autograd.grad``, never ``.backward()`` (accumulating into
``.grad`` would race).  A CUDA group on the parameters' card runs on
leaves of its own that alias that storage: autograd keeps a leaf's
gradient sink on the stream of the group that first used the leaf, and
a shared leaf would make one group's backward wait on the other group's
stream, where each group now waits on its own work only.  A group
whose device is not the parameters' device (the host CPU beside
``cuda:0``: the paper's pair) computes on a replica of the parameters on
its device, refreshed in place from the state's parameters each time a
step builds its packets, so it always sees the last update; ``collect``
moves each packet's gradients to the state's device before they are
combined.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from repro_torch.api.session import EngineSession
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import DeviceGroup
from repro_torch.core.runtime import Program
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.optim import adamw, compress as C
from repro_torch.optim.adamw import OptConfig, TrainState
from repro_torch.training.step import make_grad_fn


@dataclass
class StepReport:
    loss: float
    tokens: int
    step_time_s: float
    balance: float
    packets: int
    device_rows: Dict[str, int]
    failures: int


class HeteroDPTrainer:
    def __init__(self, cfg: ModelConfig, opt: OptConfig, shape: ShapeConfig,
                 devices: List[DeviceGroup], pipeline: SyntheticPipeline, *,
                 scheduler: str = "hguided_opt", lws: int = 1,
                 compress: bool = False):
        self.cfg = cfg
        self.opt = opt
        self.shape = shape
        self.pipeline = pipeline
        self.lws = lws
        self.compress = compress
        # the session keeps cross-step device state: throughput EWMAs feed
        # the next step's profiles, dead groups stay excluded
        self.session = EngineSession(devices, scheduler=scheduler,
                                     reset_device_stats=False,
                                     name="hetero_dp")
        self._grad = make_grad_fn(cfg)
        self._err = None      # compression error-feedback buffers
        # device -> (the parameters it copies, their replica there); a
        # CUDA group on the parameters' card: its name -> (the parameters,
        # leaves of its own over their storage)
        self._replicas: Dict[torch.device, Tuple] = {}
        self._aliases: Dict[str, Tuple] = {}
        self._replica_lock = threading.Lock()

    # -- elastic membership -------------------------------------------------
    @property
    def devices(self) -> List[DeviceGroup]:
        return self.session.devices

    def add_device(self, dev: DeviceGroup) -> None:
        self.session.add_device(dev)

    def remove_device(self, name: str) -> None:
        self.session.remove_device(name)

    def close(self) -> None:
        """Release the dispatch session (its dispatcher + device threads)."""
        self.session.close()

    # -- parameters on each group's device ------------------------------------
    def _params_on(self, params, group: DeviceGroup):
        """``params`` itself on its own device (for a CUDA group, the same
        modules over leaves of the group's own that alias the parameters'
        storage, made once); elsewhere a replica on the group's device
        (made once, then refreshed in place)."""
        device = group.device
        if next(params.parameters()).device == device:
            if not group.is_cuda:
                return params
            with self._replica_lock:
                src, rep = self._aliases.get(group.name, (None, None))
                if src is not params:
                    memo = {id(p): torch.nn.Parameter(
                        p.detach(), requires_grad=p.requires_grad)
                        for p in params.parameters()}
                    rep = copy.deepcopy(params, memo)
                    self._aliases[group.name] = (params, rep)
                return rep
        with self._replica_lock:
            src, rep = self._replicas.get(device, (None, None))
            if src is not params:
                # the module structure is copied, each parameter made
                # directly on the device (no second copy where it lives)
                memo = {id(p): torch.nn.Parameter(p.detach().to(device),
                                                  requires_grad=True)
                        for p in params.parameters()}
                rep = copy.deepcopy(params, memo)
                self._replicas[device] = (params, rep)
            else:
                with torch.no_grad():
                    for r, p in zip(rep.parameters(), params.parameters()):
                        r.copy_(p)
            return rep

    # -- one co-executed step ------------------------------------------------
    def step(self, state: TrainState,
             step_idx: int) -> Tuple[TrainState, StepReport]:
        B = self.shape.global_batch
        assert B % self.lws == 0
        G = B // self.lws
        alive = [d for d in self.session.devices if not d.dead]
        home = next(state.params.parameters()).device
        acc = {"g": None, "loss": 0.0, "rows": 0}
        rows_by_dev: Dict[str, int] = {d.name: 0 for d in alive}
        lws = self.lws

        def build(dev: DeviceGroup):
            params = self._params_on(state.params, dev)

            def fn(offset: int, size: int):
                rows = slice(offset * lws, (offset + size) * lws)
                batch = self.pipeline.batch_at(step_idx, rows=rows)
                batch = {k: dev.put(v) for k, v in batch.items()}
                (loss, _), g = self._grad(params, batch)
                return loss, g
            return fn

        def collect(pkt, res, dev):
            # runs under the run's commit lock: plain accumulation is safe
            loss, g = res
            n_rows = pkt.size * lws
            w = float(n_rows)
            # each gradient is the packet's own tensor, with a storage of
            # its own: scaled in place, the first packet's become the
            # sums, so no second copy of the model's gradients is made
            g = {n: x.to(home).mul_(w) for n, x in g.items()}
            if acc["g"] is None:
                acc["g"] = g
            else:
                for n, x in g.items():
                    acc["g"][n] += x
            acc["loss"] += float(loss) * n_rows
            acc["rows"] += n_rows
            rows_by_dev[dev.name] = rows_by_dev.get(dev.name, 0) + n_rows

        prog = Program(f"hdp_step{step_idx}", G, 1, build)
        t0 = time.perf_counter()
        # ephemeral program: the executable closes over this step's params
        result = self.session.submit(prog, collect=collect,
                                     cache=False).result()
        if acc["rows"] != B:
            raise RuntimeError(
                f"step {step_idx}: incomplete batch ({acc['rows']}/{B})")
        grads = {n: x.div_(acc["rows"]) for n, x in acc["g"].items()}
        acc["g"] = None
        if self.compress:
            if self._err is None:
                self._err = C.init_error(state.params)
            grads, self._err = C.compress_decompress(grads, self._err)
        new_state, opt_metrics = adamw.apply_updates(
            state, grads, self.opt, unstacked=self.cfg.moe.first_dense)
        if home.type == "cuda":
            torch.cuda.synchronize(home)
        dt = time.perf_counter() - t0
        fins = [b for b in result.device_busy if b > 0]
        report = StepReport(
            loss=acc["loss"] / acc["rows"],
            tokens=acc["rows"] * self.shape.seq_len,
            step_time_s=dt,
            balance=(min(fins) / max(fins)) if len(fins) > 1 else 1.0,
            packets=len(result.packets),
            device_rows=dict(rows_by_dev),
            failures=result.aborted_devices,
        )
        return new_state, report
