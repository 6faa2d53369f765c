"""Threaded fleet: ReplicaWorkers behind a FleetRouter.

The real-execution counterpart of ``fleet/sim.py``: each
:class:`ReplicaWorker` wraps a :class:`~repro_torch.serve.server.CoexecServer`
(its own ``EngineSession``, its own model replicas, its own dispatch
thread) and consumes whatever the router places on it.  Workers run with
``policy="none"`` — admission and shedding happened AT THE ROUTER; a
replica executes everything it is handed.

Elastic membership is literal: an autoscaler "up"/"down" event is applied
to the worker's session through the existing ``add_device`` /
``remove_device`` hooks (``ReplicaWorker.activate`` / ``deactivate``).
In-flight submits are unaffected — the session snapshots its device list
at dispatch time — so a scale-down never corrupts a running round; it
only stops new rounds from using the removed groups (locked by
tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.device import DeviceGroup
from repro_torch.fleet.autoscale import ElasticAutoscaler, ScaleEvent
from repro_torch.fleet.router import FleetRouter, RouterConfig
from repro_torch.serve.replica import Replica
from repro_torch.serve.server import CoexecServer, ServeOutcome, ServerConfig
from repro_torch.serve.stats import summarize
from repro_torch.serve.workload import Request, RequestQueue


class ReplicaWorker:
    """One routed executor: a CoexecServer consuming its placed share.

    The worker thread drains an inbox the router fills; each drain becomes
    one dispatch round on the worker's session.  ``declared_power`` is the
    capacity (requests/s) the worker advertises to the router up front;
    measured powers flow back through :meth:`measured_power`.
    """

    def __init__(self, name: str, replicas: Sequence[Replica],
                 cfg: ServerConfig, *, declared_power: float = 1.0):
        if declared_power <= 0:
            raise ValueError("declared_power must be > 0")
        self.name = name
        self.declared_power = declared_power
        # shedding is the router's job: the worker admits nothing away
        self.cfg = dataclasses.replace(cfg, policy="none")
        self.server = CoexecServer(replicas, self.cfg,
                                   initial_power={r.name: declared_power
                                                  / len(replicas)
                                                  for r in replicas})
        self.results: Dict[int, np.ndarray] = {}
        self.dispatch: Dict[str, int] = {}
        self.completed: List[Request] = []
        self._inbox: List[Request] = []
        self._inflight = 0                   # requests inside a round
        self._cv = threading.Condition()
        self._stop = False
        self._t0: Optional[float] = None
        self._thread = threading.Thread(target=self._loop,
                                        name=f"fleet-{name}", daemon=True)

    # -- elastic membership (the add_device/remove_device hooks) -------------
    def activate(self) -> None:
        """(Re-)attach this worker's device groups to its session."""
        session = self.server.session
        have = {d.name for d in session.devices}
        for r in self.server.replicas:
            if r.name not in have:
                # on the replica's own device, as the server built it: a
                # group's device defaults to the card
                session.add_device(DeviceGroup(r.name, device=r.device))

    def deactivate(self) -> None:
        """Detach the device groups: in-flight rounds finish untouched
        (devices were snapshotted at dispatch); new rounds can't start."""
        for r in self.server.replicas:
            self.server.session.remove_device(r.name)

    # -- the routed feed -----------------------------------------------------
    def start(self, t0: float) -> None:
        self._t0 = t0
        self._thread.start()

    def submit(self, requests: Sequence[Request]) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError(f"worker {self.name!r} is stopped")
            for r in requests:
                r.gen_alloc = self.cfg.gen
            self._inbox.extend(requests)
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._inbox and not self._stop:
                    self._cv.wait()
                if not self._inbox and self._stop:
                    return
                batch = self._inbox
                self._inbox = []
                self._inflight += len(batch)
            batch.sort(key=lambda r: (r.deadline, r.rid))
            now = time.perf_counter() - self._t0
            self.server._run_round(batch, now, self._t0, self.results,
                                   self.dispatch)
            with self._cv:
                self.completed.extend(batch)
                self._inflight -= len(batch)
                self._cv.notify_all()

    # -- router feedback -----------------------------------------------------
    def measured_power(self) -> Optional[float]:
        """Measured requests/s across the worker's replicas (None until
        the first round calibrates it)."""
        p = sum(self.server._power.values())
        return p if p > 0 and self.server._calibrated else None

    def backlog(self) -> int:
        """Routed-but-unfinished requests (inbox + in-round)."""
        with self._cv:
            return len(self._inbox) + self._inflight

    def drain(self) -> None:
        """Block until every routed request has completed."""
        with self._cv:
            while self._inbox or self._inflight:
                self._cv.wait()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join()
        self.server.close()


class FleetServer:
    """Open-loop serving across ReplicaWorkers, placed by a FleetRouter.

    The run loop polls the request queue, routes every arrival (EDF
    admission + placement + autoscaling at the router), hands placements
    to the owning workers, and periodically feeds measured worker powers
    and backlogs back into the router's EWMA book — the same
    predict/measure/correct cycle as ``simulate_fleet``, on real threads.
    """

    def __init__(self, workers: Sequence[ReplicaWorker],
                 router_cfg: Optional[RouterConfig] = None, *,
                 autoscaler: Optional[ElasticAutoscaler] = None,
                 standby: Sequence[str] = (),
                 poll_interval_s: float = 2e-3,
                 feedback_interval_s: float = 0.05):
        self.workers = list(workers)
        self._by_name = {w.name: w for w in self.workers}
        if len(self._by_name) != len(self.workers):
            raise ValueError("duplicate worker names")
        self.router = FleetRouter(
            [(w.name, w.declared_power) for w in self.workers],
            router_cfg, autoscaler=autoscaler, standby=standby,
            on_scale=self._apply_scale)
        for name in standby:
            self._by_name[name].deactivate()
        self.poll_interval_s = poll_interval_s
        self.feedback_interval_s = feedback_interval_s

    def _apply_scale(self, ev: ScaleEvent) -> None:
        w = self._by_name[ev.replica]
        if ev.action == "up":
            w.activate()
        else:
            w.deactivate()

    def run(self, queue: RequestQueue) -> ServeOutcome:
        t0 = time.perf_counter()
        for w in self.workers:
            w.start(t0)
        pending: List[Request] = []
        last_fb = 0.0
        try:
            while True:
                now = time.perf_counter() - t0
                pending.extend(queue.poll(now))
                if now - last_fb >= self.feedback_interval_s:
                    last_fb = now
                    for i, w in enumerate(self.workers):
                        p = w.measured_power()
                        # backlog in request units == the router's work
                        # units (every threaded request is one unit)
                        self.router.feedback(i, now, measured_power=p,
                                             measured_resid=w.backlog())
                if not pending:
                    nxt = queue.next_arrival()
                    if nxt is None:
                        break
                    time.sleep(min(max(nxt - now, 0.0) + 1e-4,
                                   self.feedback_interval_s))
                    continue
                placed, pending = self.router.route(pending, now)
                per_worker: Dict[int, List[Request]] = {}
                for p in placed:
                    if p.replica is not None:
                        per_worker.setdefault(p.replica, []).append(p.request)
                for idx, batch in per_worker.items():
                    self.workers[idx].submit(batch)
                if not placed:
                    time.sleep(self.poll_interval_s)
            for w in self.workers:
                w.drain()
        finally:
            for w in self.workers:
                w.stop()
        requests: List[Request] = list(self.router.shed)
        results: Dict[int, np.ndarray] = {}
        dispatch: Dict[str, int] = {}
        for w in self.workers:
            requests.extend(w.completed)
            results.update(w.results)
            for k, v in w.dispatch.items():
                dispatch[f"{w.name}:{k}"] = v
        stats = summarize(requests, duration=time.perf_counter() - t0,
                          dispatch=dispatch)
        return ServeOutcome(stats=stats, requests=requests, results=results)
