"""Framework-free parity of the PyTorch port: the scheduler, Region, energy
and metrics modules were copied with their imports rewritten, so the port
and the JAX package must make the same decisions from the same inputs."""
import numpy as np
import pytest

import repro.core.metrics as JM
import repro.core.region as JR
import repro.core.scheduler as JS
import repro.energy.meter as JEM
import repro.energy.model as JE
import repro_torch.core.metrics as TM
import repro_torch.core.region as TR
import repro_torch.core.scheduler as TS
import repro_torch.energy.meter as TEM
import repro_torch.energy.model as TE

SCHEDULERS = JS.available_schedulers()
POWERS = (("cpu", 1.0), ("igpu", 3.0), ("gpu", 7.0))
SCHED_KW = {"dynamic": {"n_packets": 16},
            "hguided_deadline": {"slack_s": 2.0},
            "hguided_steal": {"slack_s": 2.0},
            "hguided_energy": {"energy_budget_j": 40.0}}


def _work(R, geometry):
    if geometry == "line":
        return 1000, 8
    return R.Region.rect(96, 40, lws=(8, 4), offset=(16, 8)), 8


def _dims(region):
    if region is None:
        return None
    return tuple((d.offset, d.size, d.lws) for d in region.dims)


def _script(S, E, R, name, dispatch, geometry):
    """Drain one scheduler round-robin over three devices, in one thread.
    The igpu fails on its first packet (requeue + mark_dead); every other
    packet reports a fixed throughput.  Returns the decision log."""
    profiles = [S.DeviceProfile(n, p, power_model=E.PRESETS[n])
                for n, p in POWERS]
    work, lws = _work(R, geometry)
    sched = S.make_scheduler(name, work, lws, profiles,
                             **SCHED_KW.get(name, {}))
    pull = sched.acquire if dispatch == "leased" else sched.next_packet
    log, active, failed = [], [0, 1, 2], False
    for _ in range(10000):
        for i in list(active):
            pkt = pull(i)
            if pkt is None:
                continue
            row = (i, pkt.offset, pkt.size, pkt.seq, pkt.retried,
                   _dims(pkt.region))
            if i == 1 and not failed:
                failed = True
                sched.requeue(pkt)
                sched.mark_dead(i)
                sched.release(i)
                active.remove(i)
                log.append(("dead",) + row)
                continue
            wg_s = POWERS[i][1] * 100.0
            sched.note_packet_latency(i, pkt.size / wg_s)
            if hasattr(sched, "observe"):
                sched.observe(i, wg_s)
            sched.release(i)
            log.append(row)
        if sched.drained():
            return log, sched.remaining()
    raise AssertionError(f"{name}: did not drain")


@pytest.mark.parametrize("geometry", ["line", "rect"])
@pytest.mark.parametrize("dispatch", ["per_packet", "leased"])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_packet_sequence_parity(name, dispatch, geometry):
    jlog, jrem = _script(JS, JE, JR, name, dispatch, geometry)
    tlog, trem = _script(TS, TE, TR, name, dispatch, geometry)
    assert tlog == jlog
    assert trem == jrem == 0
    # exactly-once cover of the run's work by the committed packets
    total = _work(TR, geometry)[0]
    total = total if isinstance(total, int) else total.dims[0].size
    spans = sorted((r[1], r[1] + r[2]) for r in tlog if r[0] != "dead")
    pos = 0
    for a, b in spans:
        assert a == pos
        pos = b
    assert pos == total


def test_registries_match():
    assert TS.available_schedulers() == SCHEDULERS
    for name in SCHEDULERS:
        assert TS.scheduler_spec(name).defaults == \
            JS.scheduler_spec(name).defaults
        for param in ("slack_s", "energy_budget_j", "n_packets", "ewma"):
            assert TS.scheduler_accepts(name, param) == \
                JS.scheduler_accepts(name, param)


@pytest.mark.parametrize("rows,cols,lws,offset", [
    (96, 40, (8, 4), (16, 8)), (128, 128, (16, 16), (0, 0)),
    (24, 7, (8, 1), (8, 3))])
def test_region_carving_identical(rows, cols, lws, offset):
    j = JR.Region.rect(rows, cols, lws=lws, offset=offset)
    t = TR.Region.rect(rows, cols, lws=lws, offset=offset)
    assert _dims(t) == _dims(j)
    assert t.ndim == j.ndim
    for rel in range(0, rows // lws[0], 2):
        size = min(3, rows // lws[0] - rel)
        assert _dims(t.row_panel(rel, size)) == \
            _dims(j.row_panel(rel, size))
    sub_t = TR.Region.rect(lws[0], lws[1], lws=lws,
                           offset=(offset[0] + lws[0], offset[1]))
    sub_j = JR.Region.rect(lws[0], lws[1], lws=lws,
                           offset=(offset[0] + lws[0], offset[1]))
    assert t.contains(sub_t) == j.contains(sub_j)
    assert _dims(TR.as_region(t)) == _dims(JR.as_region(j))
    assert _dims(TR.as_region(50, lws=5)) == _dims(JR.as_region(50, lws=5))


def test_energy_and_metrics_identical():
    for name in ("cpu", "igpu", "gpu"):
        assert TE.PRESETS[name] == TE.PowerModel(**vars(JE.PRESETS[name]))
    tm, jm = TEM.EnergyMeter(), JEM.EnergyMeter()
    for (name, _), busy in zip(POWERS, (0.5, 1.25, 2.0)):
        kw = dict(busy_s=busy, window_s=2.5, crossings=7,
                  bytes_moved=3e6)
        tm.add(name, TE.PRESETS[name], **kw)
        jm.add(name, JE.PRESETS[name], **kw)
    tr, jr = tm.report(), jm.report()
    assert tr.total_j == jr.total_j
    assert [d.total_j for d in tr.devices] == [d.total_j for d in jr.devices]
    times = [3.0, 1.2, 0.7]
    assert TM.s_max_from_times(times) == JM.s_max_from_times(times)
    assert TM.efficiency(0.7, 0.5, times) == JM.efficiency(0.7, 0.5, times)
    assert TM.geomean(times) == JM.geomean(times)
    r = [TM.RunResult(1.0, [0.9, 1.0, 0.5], [0.9, 1.0, 0.5], []),
         JM.RunResult(1.0, [0.9, 1.0, 0.5], [0.9, 1.0, 0.5], [])]
    assert TM.balance(r[0]) == JM.balance(r[1])
    assert np.isfinite(TM.balance(r[0]))
