"""Epoch-based fleet co-simulation over ``simulate_serving`` resume hooks.

Every router policy must survive the same cross-examination the batch
schedulers get from scale1000: drive it against the calibrated
discrete-event replica models and check the outcomes.  ``simulate_fleet``
couples the analytic :class:`FleetRouter` to N *measured* replicas:

    per arrival:  router.route() — admission, placement, autoscaling —
                  against the router's EWMA book (predictions);
    per epoch:    each replica executes its routed requests through
                  ``simulate_serving(..., resume=state)``, continuing its
                  own device clocks / EWMA powers / jitter stream
                  (measurements);
    epoch end:    measured residual work and measured alive power feed
                  back into the router's book (``FleetRouter.feedback``).

The router never sees inside a replica — only declared powers up front
and measured (power, residual) feedback afterwards, exactly the contract
the threaded fleet server has.  ``crosscheck_fleet`` then replays each
replica's routed assignment one-shot through ``simulate_serving`` (via
the trace record/replay machinery, so accounting starts clean) and
compares aggregate outcomes — the fleet-level analogue of scale1000's
threaded-vs-simulated agreement gate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.simulate import SimConfig, SimDevice, ServeSimResult, \
    simulate_serving
from repro_torch.fleet.autoscale import ElasticAutoscaler
from repro_torch.fleet.router import FleetRouter, RouterConfig
from repro_torch.serve.stats import ServeStats, summarize
from repro_torch.serve.workload import TraceWorkload


@dataclass
class SimReplica:
    """One modeled replica: a named device fleet the router places onto."""
    name: str
    devices: List[SimDevice]
    lws: int = 1

    def declared_power(self) -> float:
        """What the replica advertises to the router: the (possibly
        biased) offline profile — same information Static trusts."""
        return sum(d.throughput * d.profile_bias for d in self.devices)


@dataclass
class FleetSimResult:
    requests: List                          # all offered, accounting filled
    stats: ServeStats
    router: FleetRouter
    replica_requests: Dict[str, List]       # replica -> routed requests
    replica_results: Dict[str, ServeSimResult]
    epochs: int = 0

    @property
    def scale_events(self):
        return self.router.scale_events


def simulate_fleet(requests: Sequence, replicas: Sequence[SimReplica],
                   cfg: SimConfig, router_cfg: Optional[RouterConfig] = None,
                   *, autoscaler: Optional[ElasticAutoscaler] = None,
                   standby: Sequence[str] = (),
                   epoch_s: float = 0.25,
                   batch_window_s: float = 0.0) -> FleetSimResult:
    """Route ``requests`` across ``replicas`` and execute epoch by epoch.

    Replica-side admission runs with ``policy="none"``: shedding is the
    ROUTER's decision (shared EDF admission + deadline placement); a
    replica executes everything routed to it.  ``epoch_s`` is the
    feedback granularity — measured residual/power reach the router once
    per epoch, so a smaller epoch adapts faster at more feedback traffic
    (the fleet-level lease-size trade).
    """
    if epoch_s <= 0:
        raise ValueError("epoch_s must be > 0")
    names = [rep.name for rep in replicas]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate replica names: {names}")
    router = FleetRouter(
        [(rep.name, rep.declared_power()) for rep in replicas],
        router_cfg, autoscaler=autoscaler, standby=standby)
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    n = len(replicas)
    states = [None] * n                     # per-replica ServeSimState
    routed_all: List[List] = [[] for _ in range(n)]
    busy_total: List[List[float]] = [[] for _ in range(n)]
    last_res: List[Optional[ServeSimResult]] = [None] * n
    epochs = 0
    i = 0
    carry: List = []                        # leftover beyond admit quantum

    def execute_epoch(chunks: List[List], t_end: float) -> None:
        for k, chunk in enumerate(chunks):
            if not chunk:
                continue
            res = simulate_serving(chunk, replicas[k].lws,
                                   replicas[k].devices, cfg,
                                   policy="none",
                                   batch_window_s=batch_window_s,
                                   resume=states[k])
            states[k] = res.state
            last_res[k] = res
            routed_all[k].extend(chunk)
            if res.all_dead:
                # the replica's whole device fleet died: it leaves the
                # placement set for good, like a failed device in a run
                router.states[k].active = False
        # measured feedback: outstanding work on real device clocks, the
        # schedulers' online power estimates, and the measured energy
        # cost (cumulative joules over cumulative completed work — the
        # ``energy`` placement's J/wg signal), blended into the router's
        # EWMA book (replicas with no traffic yet keep their declared
        # profile)
        for k in range(n):
            st = states[k]
            if st is None:
                continue
            jwg = None
            res = last_res[k]
            if res is not None and res.energy_j > 0:
                done_wg = sum(r.size for r in routed_all[k]
                              if r.finish is not None)
                if done_wg > 0:
                    jwg = res.energy_j / done_wg
            router.feedback(k, t_end,
                            measured_power=st.alive_power() or None,
                            measured_resid=st.residual_wg(t_end),
                            measured_j_wg=jwg)

    while i < len(reqs) or carry:
        t0 = reqs[i].arrival if i < len(reqs) else carry[0].arrival
        t1 = t0 + epoch_s
        epoch_chunks: List[List] = [[] for _ in range(n)]
        progressed = False
        while i < len(reqs) and reqs[i].arrival < t1:
            r = reqs[i]
            i += 1
            placed, carry = router.route(carry + [r], r.arrival)
            progressed = progressed or bool(placed)
            for p in placed:
                if p.replica is not None:
                    epoch_chunks[p.replica].append(p.request)
        if carry and i >= len(reqs):
            # drain the quantum leftover at the epoch boundary
            placed, carry = router.route(carry, t1)
            progressed = progressed or bool(placed)
            for p in placed:
                if p.replica is not None:
                    epoch_chunks[p.replica].append(p.request)
            if not progressed and carry:
                raise RuntimeError(
                    f"router made no progress on {len(carry)} queued "
                    "requests (admission quantum too small for any single "
                    "request?)")
        execute_epoch(epoch_chunks, t1)
        epochs += 1

    duration = max((r.finish for r in reqs if r.finish is not None),
                   default=0.0)
    # fleet energy: each replica's last (cumulative) report covers its
    # whole resumed timeline, so the fleet total is a plain sum
    fleet_j = sum(res.energy_j for res in last_res if res is not None)
    stats = summarize(reqs, duration=duration or None, energy_j=fleet_j)
    return FleetSimResult(
        requests=reqs, stats=stats, router=router,
        replica_requests={replicas[k].name: routed_all[k]
                          for k in range(n)},
        replica_results={replicas[k].name: last_res[k]
                         for k in range(n) if last_res[k] is not None},
        epochs=epochs)


def crosscheck_fleet(result: FleetSimResult, replicas: Sequence[SimReplica],
                     cfg: SimConfig, *,
                     batch_window_s: float = 0.0) -> Dict[str, float]:
    """Replay each replica's routed assignment ONE-SHOT and compare.

    The epoch-chunked co-simulation and a one-shot ``simulate_serving``
    over the same assignment should agree: chunking only changes *when*
    the replica learns about requests, not the device model.  The replay
    goes through :class:`TraceWorkload` (accounting cleared — satellite
    dogfood), runs with the same config, and the aggregate on-time count
    is compared.  Returns ``{"cosim_attainment", "replay_attainment",
    "abs_diff"}`` for the benchmark's tolerance gate.
    """
    by_name = {rep.name: rep for rep in replicas}
    offered = len(result.requests)
    on_time_replay = 0
    for name, routed in result.replica_requests.items():
        if not routed:
            continue
        rep = by_name[name]
        fresh = TraceWorkload.from_requests(routed).requests()
        res = simulate_serving(fresh, rep.lws, rep.devices, cfg,
                               policy="none",
                               batch_window_s=batch_window_s)
        on_time_replay += sum(1 for r in res.requests if r.met_slo)
    cosim = result.stats.slo_attainment
    replay = on_time_replay / offered if offered else 0.0
    return {"cosim_attainment": cosim,
            "replay_attainment": replay,
            "abs_diff": abs(cosim - replay)}
