"""The port's simulator, paper suite and calibrated autotuner against the
JAX package's: framework-free modules must give identical results for
identical inputs and seeds.  Plus the autotuner's real measurement path
on host groups, the cache, and ``EngineSession(tuned=...)``."""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.api import EngineSession as JEngineSession
from repro.configs import paper_suite as JS
from repro.core import simulate as JSim
from repro.core.device import DeviceGroup as JDeviceGroup
from repro.serve import workload as JW
from repro import tune as JT
from repro_torch.api import EngineSession, coexec
from repro_torch.configs import paper_suite as S
from repro_torch.core import programs as P
from repro_torch.core import simulate as Sim
from repro_torch.core.device import DeviceGroup
from repro_torch.serve import workload as W
from repro_torch import tune as T
from repro_torch.tune import cache as TC
from repro_torch.tune.calibrate import bytes_per_wg
from repro_torch.tune import microbench as TM
from repro_torch.tune.timing import interleaved_medians


def plain(x):
    """A dataclass tree as nested builtins, for equality across the two
    packages' (distinct but same-shaped) classes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if callable(x):
        return getattr(x, "__name__", type(x).__name__)
    return type(x).__name__


# ---------------------------------------------------------- simulator

@pytest.mark.parametrize("label,sched,kw", S.SCHED_CONFIGS)
@pytest.mark.parametrize("bench", list(S.BENCHES))
def test_paper_suite_simulation_identical(bench, label, sched, kw):
    mine, theirs = S.BENCHES[bench], JS.BENCHES[bench]
    assert (mine.total_work, mine.lws) == (theirs.total_work, theirs.lws)
    for seed in (0, 1):
        cfgs = [mod.SimConfig(scheduler=sched, scheduler_kwargs=dict(kw),
                              opt_init=True, opt_buffers=True,
                              dispatch=suite.dispatch_for(sched), seed=seed)
                for mod, suite in ((Sim, S), (JSim, JS))]
        got = Sim.simulate(mine.total_work, mine.lws, S.sim_devices(mine),
                           cfgs[0])
        want = JSim.simulate(theirs.total_work, theirs.lws,
                             JS.sim_devices(theirs), cfgs[1])
        assert plain(got) == plain(want)
        assert got.phases is not None and plain(got.phases) == plain(
            want.phases)


def test_simulate_dag_identical():
    def run(mod):
        nodes = [mod.SimNode("a", 256, 8), mod.SimNode("b", 128, 8, ("a",)),
                 mod.SimNode("c", 512, 8, ("a",)),
                 mod.SimNode("d", 64, 8, ("b", "c"))]
        devs = [mod.SimDevice("cpu", 900.0, jitter=0.2),
                mod.SimDevice("gpu", 4000.0, jitter=0.05)]
        return mod.simulate_dag(nodes, devs,
                                mod.SimConfig(scheduler="hguided", seed=3))
    assert plain(run(Sim)) == plain(run(JSim))


def test_simulate_multitenant_identical():
    def run(mod):
        tenants = [mod.SimTenant("a", 4096, weight=2.0),
                   mod.SimTenant("b", 2048, priority=1),
                   mod.SimTenant("c", 1024, exclusive=True, arrival=0.05)]
        devs = [mod.SimDevice("cpu", 8000.0, jitter=0.2),
                mod.SimDevice("igpu", 20000.0, fail_at=0.3),
                mod.SimDevice("gpu", 60000.0, jitter=0.05)]
        return mod.simulate_multitenant(
            tenants, devs, mod.SimConfig(scheduler="hguided_opt", seed=5))
    assert plain(run(Sim)) == plain(run(JSim))


def test_simulate_serving_identical():
    def run(mod, workload):
        arrivals = workload.poisson_arrivals(
            120, 200.0, np.random.default_rng(4))
        reqs = workload.make_requests(arrivals, slo=0.2, size=2)
        devs = [mod.SimDevice("cpu", 40.0, launch_overhead=1e-3,
                              jitter=0.05),
                mod.SimDevice("gpu", 150.0, launch_overhead=1e-3,
                              jitter=0.05, profile_bias=0.8)]
        cfg = mod.SimConfig(scheduler="hguided_deadline", seed=7,
                            buffer_policy="pooled")
        res = mod.simulate_serving(reqs, 2, devs, cfg, policy="shed",
                                   batch_window_s=0.01)
        return (plain({k: getattr(res, k) for k in (
                    "duration", "device_busy", "rounds", "all_dead",
                    "sched_wait", "energy")}),
                [(r.rid, r.finish, r.shed, r.replica, r.degraded)
                 for r in res.requests])
    assert run(Sim, W) == run(JSim, JW)


# -------------------------------------------------------------- tuner

PFLEET = [DeviceGroup("d0", device="cpu", throttle=1.0),
          DeviceGroup("d1", device="cpu", throttle=2.0)]
JFLEET = [JDeviceGroup("d0", throttle=1.0), JDeviceGroup("d1", throttle=2.0)]


def fake_measure(mod):
    def measure(devices, programs, rounds=7, **_):
        m = mod.Measurements(crossing_s=2e-4, wake_s=1e-4,
                             copy_s={1 << 10: 2e-6, 1 << 20: 1e-3})
        for kernel in programs:
            m.kernels[kernel] = {
                d.name: {64: 1e-3 + 64 / (1e5 / d.throttle),
                         256: 1e-3 + 256 / (1e5 / d.throttle)}
                for d in devices}
            m.n_timed_runs += 2 * len(devices) * rounds
        return m
    return measure


@pytest.mark.parametrize("total_work,lws", [(4096, 8), (1024, 32),
                                            (14336, 8)])
def test_calibration_and_search_identical(total_work, lws):
    cal = T.calibrate(fake_measure(T)(PFLEET, {"k": None}))
    jcal = JT.calibrate(fake_measure(JT)(JFLEET, {"k": None}))
    assert cal.to_dict() == jcal.to_dict()
    got = T.search(cal, "k", total_work, lws)
    want = JT.search(jcal, "k", total_work, lws)
    assert got.winner.to_dict() == want.winner.to_dict()
    assert got.default.to_dict() == want.default.to_dict()
    assert got.predictions == want.predictions
    assert got.winner.predicted_s <= got.winner.predicted_default_s


def test_autotune_hits_its_cache_and_matches_jax(tmp_path):
    progs = {"k": SimpleNamespace(total_work=4096, lws=8)}
    rep1 = T.autotune(PFLEET, progs, "k", cache=T.TuneCache(
        tmp_path / "c.json"), measure_fn=fake_measure(T))
    assert rep1.microbenches_run > 0 and not rep1.cache_hit_winner
    rep2 = T.autotune(PFLEET, progs, "k", cache=T.TuneCache(
        tmp_path / "c.json"), measure_fn=fake_measure(T))
    assert rep2.cache_hit_winner and rep2.microbenches_run == 0
    assert rep2.config == rep1.config
    jrep = JT.autotune(JFLEET, progs, "k", cache=JT.TuneCache(
        tmp_path / "jax.json"), measure_fn=fake_measure(JT))
    mine, theirs = rep1.config.to_dict(), jrep.config.to_dict()
    assert mine.pop("fingerprint") == rep1.fingerprint
    theirs.pop("fingerprint")
    assert mine == theirs


def _tuned_kw():
    return dict(kernel="k", scheduler="dynamic",
                scheduler_kwargs={"n_packets": 16}, lws=8,
                lease_overhead_s=1e-4, lease_overhead_frac=0.05,
                lease_k_max=32, async_threshold_bytes=1 << 16)


@pytest.mark.parametrize("explicit", [
    {}, {"scheduler": "static", "lease_k_max": 64},
    {"async_threshold_bytes": 4096}])
def test_session_applies_tuned_config_as_jax_does(explicit):
    cfg, jcfg = T.TunedConfig(**_tuned_kw()), JT.TunedConfig(**_tuned_kw())
    with EngineSession(PFLEET, tuned=cfg, **explicit) as s, \
            JEngineSession(JFLEET, tuned=jcfg, **explicit) as js:
        for attr in ("scheduler", "scheduler_kwargs", "lease_params",
                     "async_threshold_bytes"):
            assert getattr(s, attr) == getattr(js, attr), attr
        assert s.tuned is cfg
    if not explicit:
        assert s.scheduler == "dynamic"
        assert s.lease_params == cfg.lease_params()


def test_fingerprint_covers_the_executor_and_the_port_cache_path(
        tmp_path, monkeypatch):
    host = [DeviceGroup("g", device="cpu")]
    card = [DeviceGroup("g", device="cuda:0")]
    kinds = {}
    for kind in ("card A", "card B"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d, kind=kind: kind)
        kinds[kind] = T.device_fingerprint(card)
    assert kinds["card A"] != kinds["card B"]
    assert T.device_fingerprint(host) != kinds["card B"]
    assert T.device_fingerprint(host) == T.device_fingerprint(
        [DeviceGroup("g", device="cpu")])
    assert T.device_fingerprint(PFLEET) == T.device_fingerprint(
        PFLEET[::-1])
    parts = os.path.normpath(TC.DEFAULT_CACHE_PATH).split(os.sep)
    assert parts[-2:] == ["repro_torch", "tune_cache.json"]
    # a winner stored for one fleet is not found for the other
    cache = T.TuneCache(tmp_path / "c.json")
    cache.put_winner(T.device_fingerprint(host), "k",
                     T.TunedConfig(**_tuned_kw()))
    assert T.resolve_tuned(cache, devices=host) is not None
    assert T.resolve_tuned(cache, devices=card) is None


def test_bytes_per_wg_counts_inputs_and_a_work_groups_output():
    g1 = P.PROGRAMS["gaussian"](h=256, w=64)
    assert bytes_per_wg(g1) == pytest.approx(
        g1.in_bytes / g1.total_work + 128 * 64 * 4)
    g2 = P.PROGRAMS["gaussian2d"](h=128, w=96, lws=(16, 8))
    assert bytes_per_wg(g2) == pytest.approx(
        g2.in_bytes / 128 + 96 * 4)
    r2 = P.PROGRAMS["ray1_2d"](px=64)
    assert bytes_per_wg(r2) == pytest.approx(r2.in_bytes / 64
                                                  + 64 * 3 * 4)
    m = P.PROGRAMS["mandelbrot"](px=64, max_iter=8)
    assert bytes_per_wg(m) == 8 * 64 * 4


def test_interleaved_medians_alternates_order():
    seen = []
    med = interleaved_medians(["a", "b"], seen.append, 3)
    assert seen == ["a", "b", "b", "a", "a", "b"]
    assert set(med) == {"a", "b"} and all(v >= 0 for v in med.values())
    with pytest.raises(ValueError):
        interleaved_medians(["a"], lambda _: None, 0)


def test_autotune_measures_host_groups_then_coexec_uses_it(tmp_path):
    """The real loop on two host groups: measure (spans through
    ``DeviceGroup.run_packet``), fit, search, cache; a second call runs
    no micro-benchmark; ``coexec(tuned=...)`` then gives the reference
    output exactly."""
    kw = dict(h=64, w=64, lws=(8, 8))
    prog = P.PROGRAMS["gaussian2d"](**kw)
    fleet = [DeviceGroup("fast", device="cpu"),
             DeviceGroup("slow", device="cpu", throttle=2.0)]
    spans, n = TM.measure_compute(prog, fleet[0], rounds=2)
    assert sorted(spans) == TM.span_grid(prog) == [16, 32, 64]
    assert n == 2 * 3 and all(t > 0 for t in spans.values())
    cache = T.TuneCache(tmp_path / "c.json")
    rep = T.autotune(fleet, {"gaussian2d": prog}, "gaussian2d",
                     cache=cache, rounds=2)
    assert rep.microbenches_run > 0
    cal = cache.get_calibration(rep.fingerprint)
    assert set(cal.kernels["gaussian2d"]) == {"fast", "slow"}
    again = T.autotune(fleet, {"gaussian2d": prog}, "gaussian2d",
                       cache=T.TuneCache(tmp_path / "c.json"), rounds=2)
    assert again.microbenches_run == 0 and again.config == rep.config
    res = coexec(prog, fleet, tuned=rep.config)
    np.testing.assert_array_equal(
        res.output, P.reference_output("gaussian2d", device="cpu", **kw))
