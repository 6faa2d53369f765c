"""The port's fleet tier (``repro_torch.fleet``) on the CPU, held against
the JAX package's (``repro.fleet``).

Every case of ``tests/test_fleet.py`` runs on both packages and must give
the same record: the placements, the autoscaler and the router make the
same decisions on the same states and request lists, and
``simulate_fleet`` / ``crosscheck_fleet`` give equal results for the same
seeds (stats, routed requests by rid, scale events, epochs; a recorded
trace equal byte for byte).  The threaded ``FleetServer`` over CPU
replicas of the smoke llama returns, for every rid, the JAX fleet's
greedy tokens on the same weights; a standby worker serves nothing; a
worker re-attached by the autoscaler runs on its replicas' device."""
import dataclasses
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core.simulate as JSim
import repro.fleet as JF
import repro.serve as JS
import repro_torch.core.simulate as TSim
import repro_torch.fleet as TF
import repro_torch.serve as TS
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.core.device import DeviceGroup
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

JAX = SimpleNamespace(name="jax", F=JF, S=JS, sim=JSim)
PORT = SimpleNamespace(name="torch", F=TF, S=TS, sim=TSim)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs, so it does not starve the others'
    timing-sensitive threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _fields(r):
    """A request's fields but its prompt (an array)."""
    d = dataclasses.asdict(r)
    d.pop("prompt")
    return tuple(d.values())


def _req(M, rid, arrival, deadline, size=1):
    return M.S.Request(rid=rid, arrival=arrival, deadline=deadline,
                       size=size)


def _states(M, *powers, now=0.0):
    return [M.F.ReplicaState(name=f"rep{i}", power0=p, last_t=now)
            for i, p in enumerate(powers)]


def _book(states):
    return [dataclasses.astuple(s) for s in states]


def _event(ev):
    return None if ev is None else dataclasses.astuple(ev)


def _raises(fn):
    """The exception ``fn`` raises, as (type name, message)."""
    try:
        fn()
    except Exception as e:     # noqa: BLE001 - the record is the type
        return type(e).__name__, str(e)
    return None


# Each case of tests/test_fleet.py as a function of the package: it checks
# what that test checks and returns a record that must be equal for both.
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------- registry
@case
def builtin_placements_registered(M, tmp):
    names = M.F.available_placements()
    assert set(names) >= {"round_robin", "static", "power_prop",
                          "least_residual", "deadline", "energy"}
    assert set(M.F.PLACEMENTS) == set(names)
    return names


@case
def registry_contract_mirrors_schedulers(M, tmp):
    class MyPlacement(M.F.PlacementPolicy):
        def __init__(self, pin=0):
            self.pin = pin

        def place(self, req, now, states):
            return self.pin

    M.F.register_placement("pin", MyPlacement, defaults={"pin": 1})
    try:
        rec = [M.F.placement_spec("pin").cls is MyPlacement,
               M.F.placement_accepts("pin", "pin"),
               M.F.placement_accepts("pin", "nope"),
               M.F.make_placement("pin").pin,
               M.F.make_placement("pin", pin=2).pin,
               _raises(lambda: M.F.register_placement("pin", MyPlacement))]
        M.F.register_placement("pin", MyPlacement, overwrite=True)
    finally:
        M.F.unregister_placement("pin")
    rec += ["pin" in M.F.available_placements(),
            _raises(lambda: M.F.make_placement("pin"))]
    assert rec[:5] == [True, True, False, 1, 2]
    assert rec[5][0] == "ValueError" and "already registered" in rec[5][1]
    assert rec[6] is False and rec[7][0] == "KeyError"
    return rec


@case
def register_rejects_non_policy(M, tmp):
    got = _raises(lambda: M.F.register_placement("bad", dict))
    assert got[0] == "TypeError"
    return got


@case
def placement_accepts_builtin_params(M, tmp):
    return [(n, p, M.F.placement_accepts(n, p))
            for n in M.F.available_placements()
            for p in ("shed", "slack_margin", "nope")]


# ------------------------------------------------------------ ReplicaState
@case
def replica_state_drains_at_service_rate(M, tmp):
    s = M.F.ReplicaState("a", power0=10.0)
    s.resid = 5.0
    s.drain(0.3)                             # 3 wg served
    rec = [s.resid]
    assert s.resid == pytest.approx(2.0)
    s.drain(10.0)
    assert s.resid == 0.0                    # floors at zero
    rec += [s.resid, s.pred_finish(10.0, 20.0), s.queue_delay(10.0)]
    assert rec[2] == pytest.approx(12.0)
    return rec


@case
def replica_state_warmup_gates_ready(M, tmp):
    s = M.F.ReplicaState("a", power0=1.0, warm_at=1.0)
    rec = [s.ready(0.5), s.ready(1.0)]
    s.active = False
    rec.append(s.ready(2.0))
    assert rec == [False, True, False]
    return rec


# --------------------------------------------------------------- placements
@case
def round_robin_cycles_ready_only(M, tmp):
    pol = M.F.make_placement("round_robin")
    states = _states(M, 1.0, 1.0, 1.0)
    states[1].active = False
    picks = [pol.place(_req(M, i, 0, 1), 0.0, states) for i in range(4)]
    assert picks == [0, 2, 0, 2]
    return picks


@case
def static_shares_follow_declared_powers(M, tmp):
    pol = M.F.make_placement("static")
    states = _states(M, 3.0, 1.0)
    states[0].power = 0.01                   # live estimate must be ignored
    picks = [pol.place(_req(M, i, 0, 1), 0.0, states) for i in range(400)]
    assert picks.count(0) == 300 and picks.count(1) == 100
    return picks


@case
def power_prop_follows_live_powers(M, tmp):
    pol = M.F.make_placement("power_prop")
    states = _states(M, 3.0, 1.0)
    states[0].power = 1.0                    # measured: actually equal
    states[1].power = 1.0
    picks = [pol.place(_req(M, i, 0, 1), 0.0, states) for i in range(400)]
    assert picks.count(0) == 200 and picks.count(1) == 200
    return picks


@case
def least_residual_joins_shortest_queue(M, tmp):
    pol = M.F.make_placement("least_residual")
    states = _states(M, 1.0, 1.0)
    states[0].resid = 5.0
    picks = [pol.place(_req(M, 0, 0, 99), 0.0, states)]
    states[1].resid = 9.0
    picks.append(pol.place(_req(M, 1, 0, 99), 0.0, states))
    assert picks == [1, 0]
    return picks


@case
def deadline_places_earliest_finish_and_sheds_infeasible(M, tmp):
    pol = M.F.make_placement("deadline")
    states = _states(M, 2.0, 1.0)
    states[0].resid = 10.0                   # finish at 5+size/2
    # rep1 empty: finish at size/1 = 4 < rep0's 7 => rep1 wins despite
    # lower power
    rec = [pol.place(_req(M, 0, 0.0, 100.0, size=4), 0.0, states)]
    # no replica makes a 1s deadline => shed at the router
    rec.append(pol.place(_req(M, 1, 0.0, 1.0, size=4), 0.0, states))
    rec.append(states[1].shed_for)
    # shed=False places anyway (degrade-style fleets)
    keep = M.F.make_placement("deadline", shed=False)
    rec.append(keep.place(_req(M, 2, 0.0, 1.0, size=4), 0.0, states))
    assert rec == [1, None, 1, 1]
    return rec


@case
def energy_prefers_cheapest_feasible_after_probes(M, tmp):
    pol = M.F.make_placement("energy")
    states = _states(M, 2.0, 1.0, 1.0)
    picks = []
    for i in range(3):                   # one probe per replica
        idx = pol.place(_req(M, i, 0.0, 50.0), 0.0, states)
        states[idx].placed += 1
        picks.append(idx)
    states[0].j_wg, states[1].j_wg, states[2].j_wg = 3.0, 1.0, 2.0
    for i in range(3, 6):
        picks.append(pol.place(_req(M, i, 0.0, 50.0), 0.0, states))
    # nothing feasible: the deadline policy's shed
    picks.append(pol.place(_req(M, 6, 0.0, 0.1, size=9), 0.0, states))
    assert sorted(picks[:3]) == [0, 1, 2] and picks[3:6] == [1, 1, 1]
    assert picks[6] is None
    return picks + _book(states)


@case
def warming_fleet_falls_back_to_active_set(M, tmp):
    pol = M.F.make_placement("least_residual")
    states = _states(M, 1.0, 1.0)
    states[0].active = False
    states[1].warm_at = 5.0                  # active but still warming
    pick = pol.place(_req(M, 0, 0, 99), 0.0, states)
    assert pick == 1
    return pick


# --------------------------------------------------------------- autoscaler
def _asc(M, **kw):
    base = dict(target_delay_s=1.0, breach_s=0.5, idle_delay_s=0.1,
                idle_s=0.5, warmup_s=0.2, cooldown_s=0.3, payback=2.0,
                min_replicas=1)
    base.update(kw)
    return M.F.ElasticAutoscaler(M.F.AutoscaleConfig(**base))


@case
def scale_up_needs_sustained_breach(M, tmp):
    asc = _asc(M)
    states = _states(M, 1.0, 1.0)
    states[1].active = False
    states[0].resid = 10.0                   # delay 10 >> target 1
    evs = [asc.step(t, states) for t in (0.0, 0.4, 0.6)]
    assert evs[0] is None and evs[1] is None
    ev = evs[2]
    assert ev is not None and ev.action == "up" and ev.replica == "rep1"
    assert states[1].active and states[1].warm_at == pytest.approx(0.8)
    assert asc.warmup_cost_s == pytest.approx(0.2)
    return [_event(e) for e in evs] + _book(states) + [asc.warmup_cost_s]


@case
def scale_up_picks_most_powerful_standby_and_respects_max(M, tmp):
    asc = _asc(M, max_replicas=2)
    states = _states(M, 1.0, 2.0, 5.0)
    states[1].active = False
    states[2].active = False
    states[0].resid = 50.0
    ev = None
    t = 0.0
    while ev is None:
        ev = asc.step(t, states)
        t += 0.3
    assert ev.replica == "rep2"              # strongest spare joins first
    # fleet now at max_replicas: further breach never scales
    states[0].resid = 500.0
    later = []
    for _ in range(10):
        later.append(asc.step(t, states))
        t += 0.3
    assert later == [None] * 10
    return [_event(ev), t] + _book(states)


@case
def transient_blip_resets_dwell(M, tmp):
    asc = _asc(M)
    states = _states(M, 1.0, 1.0)
    states[1].active = False
    states[0].resid = 10.0
    rec = [asc.step(0.0, states)]            # breach dwell starts
    states[0].resid = 0.5                    # back in band
    rec.append(asc.step(0.3, states))        # resets both dwells
    states[0].resid = 10.0
    rec.append(asc.step(0.6, states))        # dwell restarted at 0.6
    rec.append(asc.step(1.2, states))
    assert rec[2] is None and rec[3] is not None
    return [_event(e) for e in rec]


@case
def scale_down_requires_idle_and_payback_residency(M, tmp):
    asc = _asc(M)
    states = _states(M, 1.0, 1.0)
    states[1].active = False
    states[0].resid = 10.0
    asc.step(0.0, states)
    up = asc.step(0.6, states)               # up at 0.6
    assert up and up.action == "up"
    states[0].resid = 0.0                    # instantly idle
    # min residency = payback*warmup + cooldown = 0.7s after the join:
    # idle dwell alone (0.5s) must NOT shrink the fleet yet
    held = [asc.step(0.7, states), asc.step(1.25, states)]
    assert held == [None, None]
    ev = None
    t = 1.4                                  # 0.8s resident: amortized
    while ev is None and t < 3.0:
        ev = asc.step(t, states)
        t += 0.2
    assert ev is not None and ev.action == "down"
    assert asc.flaps() == 0                  # guards held: no flap
    s = asc.summary()
    assert s["ups"] == 1 and s["downs"] == 1
    return [_event(up), _event(ev), t, s] + _book(states)


@case
def scale_down_respects_min_replicas(M, tmp):
    asc = _asc(M, min_replicas=2)
    states = _states(M, 1.0, 1.0)
    rec = [asc.step(t, states) for t in (0.0, 0.6, 1.2, 5.0, 9.0)]
    assert rec == [None] * 5                 # 2 active == min: hold
    return _book(states)


@case
def queue_delay_inf_when_nothing_ready(M, tmp):
    states = _states(M, 1.0)
    states[0].warm_at = 99.0
    d = M.F.ElasticAutoscaler.queue_delay(0.0, states)
    assert d == math.inf
    return d


@case
def autoscale_config_validates(M, tmp):
    rec = [_raises(lambda: M.F.AutoscaleConfig(min_replicas=0)),
           _raises(lambda: M.F.AutoscaleConfig(min_replicas=3,
                                               max_replicas=2))]
    assert [r[0] for r in rec] == ["ValueError", "ValueError"]
    return rec


# ------------------------------------------------------------------ router
@case
def router_validates_construction(M, tmp):
    rec = [_raises(lambda: M.F.FleetRouter([("a", 1.0), ("a", 2.0)])),
           _raises(lambda: M.F.FleetRouter([("a", 1.0)],
                                           standby=["ghost"])),
           _raises(lambda: M.F.FleetRouter(
               [("a", 1.0)], M.F.RouterConfig(admit="degrade"))),
           _raises(lambda: M.F.FleetRouter(
               [("a", 1.0)], M.F.RouterConfig(placement="nope")))]
    assert [r[0] for r in rec] == ["ValueError", "ValueError",
                                   "ValueError", "KeyError"]
    assert "duplicate" in rec[0][1] and "standby" in rec[1][1]
    assert "admit" in rec[2][1]
    return rec


@case
def router_places_commits_and_predicts(M, tmp):
    router = M.F.FleetRouter([("a", 2.0), ("b", 1.0)],
                             M.F.RouterConfig(placement="least_residual"))
    placed, leftover = router.route([_req(M, 0, 0.0, 100.0, size=4)], 0.0)
    assert leftover == [] and len(placed) == 1
    idx = placed[0].replica
    assert idx == 0                          # ties break to higher power
    assert router.states[idx].resid == 4.0
    assert router.states[idx].placed == 1
    assert router.predicted[0] == pytest.approx(2.0)
    assert placed[0].pred_finish == pytest.approx(2.0)
    return [idx, placed[0].pred_finish, router.predicted, repr(router),
            router.summary()] + _book(router.states)


@case
def router_sheds_fleet_infeasible_at_admission(M, tmp):
    router = M.F.FleetRouter([("a", 1.0)],
                             M.F.RouterConfig(placement="static"))
    doomed = _req(M, 0, 0.0, 0.5, size=100)
    placed, _ = router.route([doomed], 0.0)
    assert placed[0].replica is None
    assert doomed.shed and doomed.finish is None
    assert router.shed == [doomed]
    assert router.states[0].resid == 0.0     # shed work never commits
    return [_fields(doomed)] + _book(router.states)


@case
def router_deadline_placement_sheds_per_replica_infeasible(M, tmp):
    # fleet-aggregate prediction passes (2 wg/s total) but neither
    # 1 wg/s replica alone can finish 4 wg by t=3 => placement sheds
    router = M.F.FleetRouter([("a", 1.0), ("b", 1.0)],
                             M.F.RouterConfig(placement="deadline"))
    r = _req(M, 0, 0.0, 3.0, size=4)
    placed, _ = router.route([r], 0.0)
    assert placed[0].replica is None and r.shed
    assert len(router.shed) == 1
    return [_fields(r)] + _book(router.states)


@case
def router_feedback_ewma_blend(M, tmp):
    router = M.F.FleetRouter([("a", 4.0)], M.F.RouterConfig(ewma=0.5))
    router.feedback(0, 0.0, measured_power=2.0)
    rec = [router.states[0].power]
    assert rec[0] == pytest.approx(3.0)
    router.states[0].resid = 2.0
    router.states[0].last_t = 1.0
    router.feedback(0, 1.0, measured_resid=6.0, measured_j_wg=2.0)
    router.feedback(0, 1.0, measured_j_wg=4.0)
    assert router.states[0].resid == pytest.approx(4.0)
    return rec + _book(router.states)


@case
def router_standby_excluded_until_scaled_up(M, tmp):
    router = M.F.FleetRouter([("a", 1.0), ("spare", 50.0)],
                             M.F.RouterConfig(placement="least_residual"),
                             standby=["spare"])
    placed, _ = router.route([_req(M, 0, 0.0, 1e9, size=1)], 0.0)
    assert placed[0].replica == 0            # spare not placeable
    assert router.fleet_power(0.0) == pytest.approx(1.0)
    return [placed[0].replica, router.fleet_power(0.0)]


@case
def router_autoscales_through_on_scale_hook(M, tmp):
    seen = []
    asc = _asc(M, max_replicas=2)
    router = M.F.FleetRouter([("a", 1.0), ("spare", 2.0)],
                             M.F.RouterConfig(placement="deadline",
                                              admit="none"),
                             autoscaler=asc, standby=["spare"],
                             on_scale=seen.append)
    rid, out = 0, []
    for k in range(12):                      # a burst, then a long idle
        t = 0.25 * k
        batch = [_req(M, rid + j, t, t + 100.0) for j in range(3)] \
            if k < 4 else []
        rid += len(batch)
        placed, _ = router.route(batch, t)
        out += [(p.request.rid, p.replica, p.pred_finish) for p in placed]
    assert [e.replica for e in seen] == ["spare"]
    assert router.scale_events == seen
    return out + [_event(e) for e in seen] + _book(router.states)


# -------------------------------------------------------- fleet co-sim
def _sim_cfg(M, seed=0):
    return M.sim.SimConfig(scheduler="hguided_opt", opt_init=True,
                           opt_buffers=True, host_cost_per_packet=1e-4,
                           seed=seed)


def _fleet(M, n=3, jitter=0.05):
    reps = []
    for k in range(n):
        devs = [M.sim.SimDevice(f"rep{k}.d0", 40.0 + 10 * k, jitter=jitter,
                                launch_overhead=1e-3),
                M.sim.SimDevice(f"rep{k}.d1", 20.0, jitter=jitter,
                                launch_overhead=1e-3)]
        reps.append(M.F.SimReplica(f"rep{k}", devs))
    return reps


def _workload(M, n=300, rate=120.0, slo=0.5, size=2, seed=0):
    rng = np.random.default_rng(seed)
    return M.S.make_requests(M.S.poisson_arrivals(n, rate, rng), slo,
                             size=size)


def _sim_record(res):
    """What a fleet co-simulation decided and measured."""
    return [[_fields(r) for r in res.requests], repr(res.stats),
            {k: [r.rid for r in v]
             for k, v in res.replica_requests.items()},
            [_event(e) for e in res.scale_events], res.epochs,
            {k: (v.rounds, v.duration, v.device_busy, v.all_dead,
                 v.energy_j) for k, v in res.replica_results.items()},
            res.router.summary(), _book(res.router.states)]


@case
def simulate_fleet_exact_request_cover(M, tmp):
    reqs = _workload(M)
    res = M.F.simulate_fleet(reqs, _fleet(M), _sim_cfg(M),
                             M.F.RouterConfig(placement="deadline"),
                             epoch_s=0.2)
    # every offered request resolves exactly one way
    for r in res.requests:
        assert r.shed != (r.finish is not None)
    routed_rids = sorted(r.rid for chunk in res.replica_requests.values()
                         for r in chunk)
    served_rids = sorted(r.rid for r in res.requests if not r.shed)
    assert routed_rids == served_rids        # disjoint exact partition
    assert len(res.router.shed) == sum(1 for r in res.requests if r.shed)
    assert res.stats.n_requests == len(reqs)
    return _sim_record(res)


@case
def simulate_fleet_deterministic(M, tmp):
    a, b = (M.F.simulate_fleet(_workload(M, seed=5), _fleet(M), _sim_cfg(M),
                               M.F.RouterConfig(placement="least_residual"),
                               epoch_s=0.15) for _ in range(2))
    for ra, rb in zip(a.requests, b.requests):
        assert (ra.rid, ra.shed, ra.finish, ra.replica) \
            == (rb.rid, rb.shed, rb.finish, rb.replica)
    return _sim_record(a)


@case
def simulate_fleet_trace_replay_bit_identical(M, tmp):
    """Record a fleet run, replay the trace through the same router and
    fleet: bit-identical outcomes (the trace harness's core claim)."""
    res = M.F.simulate_fleet(_workload(M, seed=2), _fleet(M), _sim_cfg(M),
                             M.F.RouterConfig(placement="deadline"),
                             epoch_s=0.2)
    tmp.mkdir(parents=True, exist_ok=True)
    path = str(tmp / "fleet.jsonl")
    n = M.S.record_trace(res, path)
    assert n == len(res.requests)
    replayed = M.S.TraceWorkload.load(path).requests()
    res2 = M.F.simulate_fleet(replayed, _fleet(M), _sim_cfg(M),
                              M.F.RouterConfig(placement="deadline"),
                              epoch_s=0.2)
    for a, b in zip(res.requests, res2.requests):
        assert (a.rid, a.shed, a.finish, a.replica) \
            == (b.rid, b.shed, b.finish, b.replica)
    with open(path) as f:
        trace = f.read()
    return [trace] + _sim_record(res2)


@case
def serve_resume_chunked_matches_one_shot(M, tmp):
    """ServeSimState carry-over: splitting a request stream at a drain
    point and resuming must reproduce the one-shot run bit-identically
    (device clocks, EWMA powers, pipeline fill, jitter stream)."""
    def devs():
        return [M.sim.SimDevice("d0", 50.0, jitter=0.1,
                                launch_overhead=1e-3),
                M.sim.SimDevice("d1", 25.0, jitter=0.1,
                                launch_overhead=1e-3)]

    rng = np.random.default_rng(4)
    first = M.S.make_requests(M.S.poisson_arrivals(80, 60.0, rng), 0.6,
                              size=1)
    gap = first[-1].arrival + 5.0            # fleet fully drains
    second = [M.S.Request(rid=100 + i, arrival=gap + a,
                          deadline=gap + a + 0.6)
              for i, a in enumerate(M.S.poisson_arrivals(80, 60.0, rng))]

    def clone(rs):
        return [M.S.Request(rid=r.rid, arrival=r.arrival,
                            deadline=r.deadline, size=r.size) for r in rs]

    one = clone(first) + clone(second)
    res_one = M.sim.simulate_serving(one, 1, devs(), _sim_cfg(M, 9),
                                     policy="shed")
    devs2 = devs()
    c1 = clone(first)
    r1 = M.sim.simulate_serving(c1, 1, devs2, _sim_cfg(M, 9), policy="shed")
    c2 = clone(second)
    r2 = M.sim.simulate_serving(c2, 1, devs2, _sim_cfg(M, 9), policy="shed",
                                resume=r1.state)
    assert r2.rounds == res_one.rounds       # cumulative across the resume
    chunked = {r.rid: r for r in c1 + c2}
    for r in one:
        c = chunked[r.rid]
        assert (r.shed, r.finish, r.replica) == (c.shed, c.finish, c.replica)
    return [[_fields(r) for r in one], r2.rounds, r2.duration,
            r2.device_busy, r2.state.residual_wg(gap + 10.0),
            r2.state.alive_power()]


@case
def serve_resume_rejects_device_mismatch(M, tmp):
    devs = [M.sim.SimDevice("d0", 50.0)]
    reqs = _workload(M, n=10, rate=50.0)
    res = M.sim.simulate_serving(reqs, 1, devs, _sim_cfg(M), policy="none")
    got = _raises(lambda: M.sim.simulate_serving(
        _workload(M, n=10, rate=50.0), 1,
        [M.sim.SimDevice("a", 1.0), M.sim.SimDevice("b", 1.0)],
        _sim_cfg(M), resume=res.state))
    assert got[0] == "ValueError" and "resume state" in got[1]
    return got


@case
def crosscheck_fleet_within_tolerance(M, tmp):
    fleet = _fleet(M)
    res = M.F.simulate_fleet(_workload(M, n=250, rate=100.0, seed=1), fleet,
                             _sim_cfg(M),
                             M.F.RouterConfig(placement="deadline"),
                             epoch_s=0.2)
    cc = M.F.crosscheck_fleet(res, fleet, _sim_cfg(M))
    assert 0.0 <= cc["cosim_attainment"] <= 1.0
    assert cc["abs_diff"] <= 0.08
    return [cc] + _sim_record(res)


@case
def simulate_fleet_autoscales_on_burst(M, tmp):
    rng = np.random.default_rng(0)
    storm = M.S.poisson_arrivals(250, 260.0, rng)      # ~2x core capacity
    tail0 = storm[-1] + 3.0
    tail = [tail0 + 0.5 * k for k in range(8)]
    reqs = M.S.make_requests(list(storm) + tail, 0.8, size=2)
    fleet = _fleet(M, 5)
    standby = [rep.name for rep in fleet[3:]]
    asc = M.F.ElasticAutoscaler(M.F.AutoscaleConfig(
        target_delay_s=0.4, breach_s=0.1, idle_delay_s=0.05, idle_s=0.5,
        warmup_s=0.1, cooldown_s=0.2, min_replicas=3))
    res = M.F.simulate_fleet(reqs, fleet, _sim_cfg(M),
                             M.F.RouterConfig(placement="deadline"),
                             autoscaler=asc, standby=standby, epoch_s=0.1)
    s = asc.summary()
    assert s["ups"] >= 1                     # breach grew the fleet
    assert s["downs"] >= 1                   # idle tail shrank it
    assert s["flaps"] == 0                   # and never thrashed
    assert s["warmup_cost_s"] == pytest.approx(0.1 * s["ups"])
    # scale events landed on the states: spares served real traffic
    assert sum(len(res.replica_requests[name]) for name in standby) > 0
    return [s] + _sim_record(res)


@case
def simulate_fleet_energy_placement(M, tmp):
    fleet = _fleet(M)
    for k, rep in enumerate(fleet):
        for d in rep.devices:
            d.power_model = M.sim.PowerModel(busy_w=100.0 + 50.0 * k,
                                             idle_w=10.0)
    res = M.F.simulate_fleet(_workload(M, n=200, rate=90.0, seed=3), fleet,
                             _sim_cfg(M),
                             M.F.RouterConfig(placement="energy"),
                             epoch_s=0.2)
    assert res.stats.energy_j > 0
    return _sim_record(res)


@case
def simulate_fleet_rejects_bad_args(M, tmp):
    reps = _fleet(M, 2)
    reps[1].name = reps[0].name
    rec = [_raises(lambda: M.F.simulate_fleet([], _fleet(M), _sim_cfg(M),
                                              epoch_s=0.0)),
           _raises(lambda: M.F.simulate_fleet([], reps, _sim_cfg(M)))]
    assert rec[0][0] == "ValueError" and "epoch_s" in rec[0][1]
    assert rec[1][0] == "ValueError" and "duplicate" in rec[1][1]
    return rec


@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_case_matches_jax(name, tmp_path):
    """The case's checks hold on both packages, and its record is equal."""
    want = CASES[name](JAX, tmp_path / "jax")
    got = CASES[name](PORT, tmp_path / "torch")
    assert got == want


def test_fleet_exports_match_jax():
    assert TF.__all__ == JF.__all__
    assert TF.available_placements() == JF.available_placements()


# ---------------------------------------- threaded fleet, CPU replicas
N_PROMPTS, PROMPT, GEN, LWS = 8, 16, 2, 2


@pytest.fixture(scope="module")
def smoke_pair():
    """The smoke llama in both packages on the same weights, and prompts."""
    jcfg, cfg = jax_get_smoke("llama3.2-1b"), get_smoke("llama3.2-1b")
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (N_PROMPTS, PROMPT)).astype(np.int32)
    return (jcfg, jparams), (cfg, params), prompts


def _worker(M, model, name, power=4.0):
    cfg, params = model
    scfg = M.S.ServerConfig(scheduler="hguided_deadline", lws=LWS, gen=GEN)
    kw = {} if M is JAX else {"device": "cpu"}
    rep = M.S.Replica(name + ".a", cfg, params, **kw)
    return M.F.ReplicaWorker(name, [rep], scfg, declared_power=power)


def _requests(M, prompts):
    return M.S.make_requests([0.0] * len(prompts), slo=300.0,
                             prompt_fn=lambda i: prompts[i])


@pytest.fixture(scope="module")
def jax_fleet_tokens(smoke_pair):
    """The JAX fleet's greedy tokens by rid (two workers)."""
    jmodel, _, prompts = smoke_pair
    fleet = JF.FleetServer([_worker(JAX, jmodel, "w0"),
                            _worker(JAX, jmodel, "w1")],
                           JF.RouterConfig(placement="least_residual",
                                           admit="none"))
    out = fleet.run(JS.RequestQueue(_requests(JAX, prompts)))
    assert out.stats.served == N_PROMPTS
    return {rid: np.asarray(t) for rid, t in out.results.items()}


def _session_on_cpu(w):
    return all(not g.is_cuda and g.device.type == "cpu"
               for g in w.server.session.devices)


@pytest.mark.parametrize("standby", [False, True])
def test_fleet_server_tokens_match_jax(smoke_pair, jax_fleet_tokens,
                                       standby):
    """Two CPU workers (or one and a standby spare) serve every request,
    with the JAX fleet's greedy tokens for every rid; dispatch is
    namespaced per worker and the standby serves nothing."""
    _, model, prompts = smoke_pair
    workers = [_worker(PORT, model, "w0"),
               _worker(PORT, model, "spare" if standby else "w1",
                       power=50.0 if standby else 4.0)]
    fleet = TF.FleetServer(workers,
                           TF.RouterConfig(placement="least_residual",
                                           admit="none"),
                           standby=["spare"] if standby else [])
    if standby:
        assert workers[1].server.session.devices == []   # detached at init
    out = fleet.run(TS.RequestQueue(_requests(PORT, prompts)))
    assert out.stats.served == N_PROMPTS and out.stats.shed == 0
    assert all(":" in k for k in out.stats.dispatch)
    assert sum(out.stats.dispatch.values()) == N_PROMPTS
    if standby:
        assert not any(k.startswith("spare:") for k in out.stats.dispatch)
    assert set(out.results) == set(jax_fleet_tokens)
    for rid, want in jax_fleet_tokens.items():
        np.testing.assert_array_equal(out.results[rid], want)


def test_worker_activate_deactivate_toggles_session(smoke_pair):
    _, model, _ = smoke_pair
    w = _worker(PORT, model, "w0")
    try:
        assert [d.name for d in w.server.session.devices] == ["w0.a"]
        w.deactivate()
        assert w.server.session.devices == []
        w.activate()
        assert [d.name for d in w.server.session.devices] == ["w0.a"]
        with pytest.raises(ValueError, match="already in session"):
            w.server.session.add_device(DeviceGroup("w0.a", device="cpu"))
    finally:
        w.stop()


@pytest.mark.parametrize("how", ["activate", "apply_scale"])
def test_reattached_worker_serves_on_its_replicas_device(
        smoke_pair, jax_fleet_tokens, how):
    """A worker detached and re-attached (by ``activate`` or by the fleet's
    scale-up hook) gets its groups back on its replicas' device, here the
    CPU, and serves the same tokens."""
    _, model, prompts = smoke_pair
    w = _worker(PORT, model, "w0")
    fleet = TF.FleetServer([w], TF.RouterConfig(placement="least_residual",
                                                admit="none"))
    if how == "activate":
        w.deactivate()
        assert w.server.session.devices == []
        w.activate()
    else:
        for action in ("down", "up"):
            fleet._apply_scale(TF.ScaleEvent(t=0.0, action=action,
                                             replica="w0", queue_delay_s=0.0,
                                             reason="test"))
    assert [d.name for d in w.server.session.devices] == ["w0.a"]
    assert _session_on_cpu(w)
    out = fleet.run(TS.RequestQueue(_requests(PORT, prompts)))
    assert out.stats.served == N_PROMPTS
    assert _session_on_cpu(w)
    for rid, want in jax_fleet_tokens.items():
        np.testing.assert_array_equal(out.results[rid], want)


def test_fleet_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.fleet\n"
            "from repro_torch.fleet import worker, sim, router\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
