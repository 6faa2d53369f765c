"""CoexecServer: deadline-aware open-loop serving on the co-execution stack.

Generalizes the old fixed-batch worker loop into a continuous serving
engine.  The request stream is the co-execution work set (1 work-group =
one request); the paper's schedulers are the dispatch engine across
heterogeneous replicas.  Dataflow per *dispatch round*:

    RequestQueue --poll(now)--> admission (EDF order, shed/degrade)
        --> scheduler over the admitted round (HGuided* packets)
        --> replica worker threads pull packets, decode, commit
        --> per-request latency accounting + EWMA power feedback

* **Admission (EDF-within-round)**: pending requests are sorted by
  deadline; each request's completion is predicted from the replicas'
  online EWMA computing powers (the same estimates HGuidedOpt adapts
  with).  A request predicted to miss is *shed* (dropped now, so its
  work cannot drag every later request past its deadline too) or
  *degraded* (granted proportionally fewer decode tokens) per policy.
* **Dispatch**: the admitted round becomes one ``EngineSession`` submit —
  one work-group per request, one Program whose range function serves
  ``lws``-sized sub-batches on the packet's replica.  Any registered
  scheduler works; ``hguided_deadline`` additionally receives the round's
  tightest slack (``slack_s``) so packets shrink as deadlines close in.
* **Feedback**: measured requests/s per replica updates both the live
  scheduler (within-round adaptation) and the server's EWMA powers
  (carried across rounds — the admission predictor and the next round's
  initial profile).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.policies import OffloadMode
from repro_torch.api.session import EngineSession
from repro_torch.core.device import DeviceGroup
from repro_torch.core.runtime import Program
from repro_torch.core.scheduler import rotate_static_order, scheduler_accepts
from repro_torch.energy.model import ZERO_POWER, PowerModel
from repro_torch.serve.admission import AdmissionConfig, EdfAdmission
from repro_torch.serve.replica import Replica
from repro_torch.serve.stats import ServeStats, summarize
from repro_torch.serve.workload import Request, RequestQueue


@dataclass
class ServerConfig:
    scheduler: str = "hguided_deadline"
    scheduler_kwargs: Dict = field(default_factory=dict)
    lws: int = 1                  # requests per packet alignment unit
    gen: int = 16                 # decode tokens per request
    policy: str = "shed"          # "shed" | "degrade" | "none"
    min_gen: int = 1              # floor for degraded requests
    ewma: float = 0.5             # cross-round power smoothing
    poll_interval_s: float = 2e-3
    batch_window_s: float = 0.0   # micro-batching: wait for round to fill
    round_quantum_s: float = float("inf")  # max EDF-first work per round
    warmup: bool = True           # warm every replica before the clock
    # scheduler hand-off for dispatch rounds: "leased" (lock-amortized
    # packet plans; with scheduler="hguided_steal" idle replicas also
    # steal from the largest victim lease) or "per_packet" (baseline)
    dispatch: str = "leased"
    # per-replica power models (name -> PowerModel) for joule accounting;
    # unlisted replicas stay joule-blind (ZERO_POWER), so the default is
    # a behavior- and stats-identical server with energy_j == 0
    power_models: Dict[str, PowerModel] = field(default_factory=dict)


def _no_collect(pkt, res, dev) -> None:
    """Round programs commit per-request state in their range function."""


@dataclass
class ServeOutcome:
    stats: ServeStats
    requests: List[Request]
    results: Dict[int, np.ndarray]        # rid -> generated tokens


class CoexecServer:
    """Continuous admission + co-execution dispatch over model replicas."""

    def __init__(self, replicas: Sequence[Replica], cfg: ServerConfig, *,
                 initial_power: Optional[Dict[str, float]] = None):
        assert cfg.policy in ("shed", "degrade", "none")
        self.replicas = list(replicas)
        self.cfg = cfg
        # requests/s per replica.  Admission needs an absolute scale: until
        # one round has been observed, predictions are uncalibrated and
        # admission lets everything through (unless the caller provides
        # measured powers up front).
        self._power: Dict[str, float] = dict(initial_power or {})
        self._calibrated = initial_power is not None
        self._round = 0
        self._lock = threading.Lock()
        # one dispatch group per replica.  Heterogeneity is emulated inside
        # the round program (replica.group.throttle scales each sub-batch),
        # so the dispatch groups themselves are unthrottled — the session
        # must not throttle a second time.
        self._by_name = {r.name: r for r in self.replicas}
        # admission is a shared policy object (serve/admission.py): the
        # same EDF + shed/degrade procedure the fleet router runs one rung
        # up.  unit_work: the threaded server prices every request at one
        # work-group, matching the requests/s scale of its EWMA powers.
        self.admission = EdfAdmission(AdmissionConfig(
            policy=cfg.policy, gen=cfg.gen, min_gen=cfg.min_gen,
            round_quantum_s=cfg.round_quantum_s, unit_work=True))
        # each dispatch group runs on its replica's device: a card's group
        # runs its packets on a stream of its own and waits only on them
        # before it reads a packet's time
        self.session = EngineSession(
            [DeviceGroup(r.name, device=r.device,
                         power_model=cfg.power_models.get(r.name,
                                                          ZERO_POWER))
             for r in self.replicas],
            scheduler=cfg.scheduler, dispatch=cfg.dispatch,
            name="coexec_server")
        self._energy_j = 0.0          # joules across all dispatch rounds

    # -- admission -----------------------------------------------------------
    def _admit(self, pending: List[Request], now: float,
               completed: List[Request]
               ) -> Tuple[List[Request], List[Request]]:
        """EDF-order ``pending``; shed/degrade predicted misses in place.

        Thin wrapper over the shared :class:`EdfAdmission` policy object
        (serve/admission.py — also the fleet router's admitter).  Returns
        (admitted round, leftover beyond the round quantum) — the leftover
        stays queued so EDF re-sorting / re-prediction happens every
        quantum instead of once per backlog (iteration-level scheduling).
        """
        return self.admission.admit(
            pending, now,
            total_power=sum(self._power.values()),
            calibrated=self._calibrated,
            completed=completed)

    # -- dispatch ------------------------------------------------------------
    def _run_round(self, admitted: List[Request], now: float, t0: float,
                   results: Dict[int, np.ndarray],
                   dispatch: Dict[str, int]) -> None:
        cfg = self.cfg
        powers = [self._power.get(r.name, 1.0 / r.group.throttle)
                  for r in self.replicas]
        skw = dict(cfg.scheduler_kwargs)
        order = rotate_static_order(cfg.scheduler, len(self.replicas),
                                    self._round)
        if order is not None:
            skw.setdefault("order", order)
        if scheduler_accepts(cfg.scheduler, "slack_s"):
            skw["slack_s"] = min(r.deadline for r in admitted) - now
        self._round += 1

        def build(group: DeviceGroup):
            rep = self._by_name[group.name]

            def fn(offset: int, size: int):
                # execute in lws-sized sub-batches: fixed batch shapes keep
                # the kernels' and matmuls' shapes (and so their results)
                # independent of the packet size, and give finer
                # per-request completion times
                for c0 in range(0, size, cfg.lws):
                    sub = admitted[offset + c0:
                                   offset + min(c0 + cfg.lws, size)]
                    gen_eff = min(r.gen_alloc for r in sub)
                    # pad to exactly lws rows and pin the cache length:
                    # one (prefill, decode) shape serves every packet,
                    # whatever the round or degrade policy carved
                    rows = [r.prompt for r in sub]
                    rows += [rows[-1]] * (cfg.lws - len(rows))
                    prompts = np.stack(rows)
                    cache_len = prompts.shape[1] + cfg.gen
                    t_pkt = time.perf_counter()
                    toks = rep.serve(prompts, gen_eff, cache_len)
                    dt = time.perf_counter() - t_pkt
                    if rep.group.throttle > 1:    # emulated heterogeneity
                        time.sleep(dt * (rep.group.throttle - 1))
                        dt *= rep.group.throttle
                    fin = time.perf_counter() - t0
                    rps = len(sub) / max(dt, 1e-9)
                    with self._lock:
                        for j, r in enumerate(sub):
                            r.finish = fin
                            r.replica = rep.name
                            r.degraded = r.degraded or gen_eff < cfg.gen
                            results[r.rid] = toks[j]
                        dispatch[rep.name] = (dispatch.get(rep.name, 0)
                                              + len(sub))
                        prev = self._power.get(rep.name)
                        self._power[rep.name] = rps if prev is None else (
                            cfg.ewma * rps + (1 - cfg.ewma) * prev)
            return fn

        # one work-group per admitted request; results are committed by the
        # range function itself, so collect is a no-op sink.  Rounds are
        # BINARY offloads: each is self-contained (fresh build, teardown
        # after) — a round program never recurs, so nothing must survive it
        prog = Program(f"round{self._round}", len(admitted), cfg.lws, build)
        res = self.session.submit(prog, powers=powers, scheduler=cfg.scheduler,
                                  scheduler_kwargs=skw, collect=_no_collect,
                                  mode=OffloadMode.BINARY).result()
        self._energy_j += getattr(res, "energy_j", 0.0)
        self._calibrated = True

    # -- main entry ----------------------------------------------------------
    def _warmup(self, queue: RequestQueue) -> None:
        """Run prefill + decode once at the serving batch shape on every
        replica BEFORE the clock starts — cold-start costs (the kernels'
        build, the first library calls) must not poison the EWMA powers
        the admission predictor relies on."""
        first = queue.preview()
        if first is None or first.prompt is None:
            return
        prompts = np.stack([first.prompt] * self.cfg.lws)
        cache_len = prompts.shape[1] + self.cfg.gen
        for rep in self.replicas:
            rep.serve(prompts, 1, cache_len)

    def run(self, queue: RequestQueue) -> ServeOutcome:
        """Serve the whole queue open-loop; returns stats + outputs."""
        if self.cfg.warmup:
            self._warmup(queue)
        t0 = time.perf_counter()
        completed: List[Request] = []
        results: Dict[int, np.ndarray] = {}
        dispatch: Dict[str, int] = {r.name: 0 for r in self.replicas}
        pending: List[Request] = []
        while True:
            now = time.perf_counter() - t0
            pending.extend(queue.poll(now))
            if not pending:
                nxt = queue.next_arrival()
                if nxt is None:
                    break
                # the queue is fixed at run() time: nothing can arrive
                # before nxt, so sleep straight through to it
                time.sleep(max(nxt - now, 0.0) + 1e-4)
                continue
            # micro-batching: hold a young round open while more requests
            # are still inbound, so the scheduler has work to split
            oldest = min(r.arrival for r in pending)
            if (self.cfg.batch_window_s > 0
                    and queue.next_arrival() is not None
                    and now - oldest < self.cfg.batch_window_s):
                time.sleep(self.cfg.poll_interval_s)
                continue
            admitted, pending = self._admit(pending, now, completed)
            if not admitted:
                continue
            self._run_round(admitted, now, t0, results, dispatch)
            completed.extend(admitted)
        stats = summarize(completed, duration=time.perf_counter() - t0,
                          dispatch=dispatch, energy_j=self._energy_j)
        return ServeOutcome(stats=stats, requests=completed, results=results)

    def close(self) -> None:
        """Release the dispatch session (a server can serve many queues;
        close when done)."""
        self.session.close()
