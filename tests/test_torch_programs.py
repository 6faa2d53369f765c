"""The port's whole program suite on the CPU: the six programs the first
slices lacked (``gaussian2d``, ``mandelbrot2d``, ``ray1``, ``ray2``,
``ray1_2d``, ``ray2_2d``) against the JAX package's ``reference_output``,
the 2-D co-execution and ROI offloading inside the port, banded ray
rendering, and the run journal against the JAX package's.

Tolerances against the JAX package, all from the same numpy inputs:

* gaussian2d at rtol/atol 1e-5 (``tests/test_kernels.py``);
* mandelbrot2d on at most 0.5% of pixels differing (XLA:CPU contracts
  ``a*b+c`` into an FMA, PyTorch does not; 2 of 4,096 pixels at 64 px);
* ray at rtol 1e-5 / atol 1e-4 with no pixel flipped (a flip — hit
  against miss, lit against shadowed — moves a channel by more than
  1e-2).  The JAX reference runs the scene under ``jax.jit``, whose
  fused float32 arithmetic differs from its own op-by-op version by up to
  8.5e-5 at 64 px (scene 1), while the port stays within 2.4e-7 of that
  op-by-op version.  At 256 px the JIT-compiled JAX version flips a
  pixel against its own op-by-op one, so the cross-framework check stays
  at 64 px.

Inside the port every comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JC
from repro.core import programs as JP
from repro.kernels.ray import ref as JR
from repro_torch.api import (EngineSession, OffloadMode, Region, RunJournal,
                             coexec, resume_run)
from repro_torch.ckpt.checkpoint import merge_spans
from repro_torch.core import programs as P
from repro_torch.core.device import DeviceGroup
from repro_torch.kernels.gaussian import kernel as KG
from repro_torch.kernels.mandelbrot import kernel as KM
from repro_torch.kernels.ray import ops as RO
from repro_torch.kernels.ray import ref as RR

SIZES = {
    "gaussian2d": dict(h=128, w=96, lws=(16, 8)),
    "mandelbrot2d": dict(px=64),
    "ray1": dict(px=64),
    "ray2": dict(px=64),
    "ray1_2d": dict(px=64),
    "ray2_2d": dict(px=64),
}
SCHEDULERS = ["dynamic", "hguided", "hguided_deadline", "hguided_energy",
              "hguided_opt", "hguided_steal", "static", "static_rev"]
RAY_TOL = (1e-5, 1e-4)
RAY_FLIP = 1e-2
MANDEL_MAX_DIFF = 0.005


def devices3():
    return [DeviceGroup("cpu", device="cpu", throttle=3.0),
            DeviceGroup("igpu", device="cpu", throttle=1.5),
            DeviceGroup("gpu", device="cpu", throttle=1.0)]


_REFS = {}


def port_ref(name):
    if name not in _REFS:
        _REFS[name] = P.reference_output(name, device="cpu", **SIZES[name])
    return _REFS[name]


def assert_matches_jax(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if name.startswith("mandelbrot"):
        assert (got != want).mean() <= MANDEL_MAX_DIFF
    elif name.startswith("ray"):
        per_px = np.abs(got - want).reshape(got.shape[0], -1, 3).max(-1)
        assert int((per_px > RAY_FLIP).sum()) == 0
        np.testing.assert_allclose(got, want, rtol=RAY_TOL[0],
                                   atol=RAY_TOL[1])
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- the suite

def test_program_suite_has_the_jax_packages_names():
    assert sorted(P.PROGRAMS) == sorted(JP.PROGRAMS)


@pytest.mark.parametrize("name", list(SIZES))
def test_reference_output_matches_jax(name):
    want = JP.reference_output(name, **SIZES[name])
    assert_matches_jax(name, port_ref(name), want)


@pytest.mark.parametrize("which", [1, 2])
def test_ray_scene_byte_identical(which):
    mine, theirs = RR.make_scene(which), JR.make_scene(which)
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
        assert np.array_equal(v, np.asarray(theirs[k]))


def test_ray_all_miss_rays_take_index_zero():
    """A ray that misses every sphere has t = inf everywhere; argmin must
    give index 0, the first of equal minima, as jnp.argmin does."""
    scene = {k: torch.from_numpy(v) for k, v in RR.make_scene(1).items()}
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)        # away from the scene
    t, idx = RR._intersect(o, d, scene["centers"], scene["radii"])
    assert torch.isinf(t).all() and (idx == 0).all()


@pytest.mark.parametrize("which,px,rows,cols", [
    (1, 64, (0, 64), (0, 64)), (2, 96, (20, 36), (8, 72)),
    (1, 128, (4, 100), (40, 24))])
def test_banded_ray_equals_unbanded(monkeypatch, which, px, rows, cols):
    scene = {k: torch.from_numpy(v) for k, v in RR.make_scene(which).items()}
    whole = RR.render_rows(scene, rows[0], rows[1], px, px, cols[0], cols[1])
    full = RR.render_rows(scene, rows[0] // RO.LWS * RO.LWS, 2 * RO.LWS, px,
                          px)
    for band in (1, 3, 7):
        # a budget of ``band`` rows of the tile's (cols, spheres, 3)
        monkeypatch.setattr(RO, "BAND_ELEMS", band * cols[1] * 32 * 3)
        assert RO._band_rows(cols[1], 32) == band
        got = RO.run_region(scene, rows[0], rows[1], cols[0], cols[1],
                            width=px, height=px)
        assert torch.equal(got, whole)
        monkeypatch.setattr(RO, "BAND_ELEMS", band * px * 32 * 3)
        assert torch.equal(RO.run_range(scene, rows[0] // RO.LWS, 2,
                                        width=px, height=px), full)


@pytest.mark.parametrize("name", ["ray1", "ray2_2d"])
def test_ray_program_stages_pixel_axes_once(monkeypatch, name):
    """A built ray program slices the pixel coordinates it staged at build
    time: its bands make none, so a card's band loop copies nothing."""
    made = []
    real = RR.pixel_axes
    monkeypatch.setattr(RR, "pixel_axes",
                        lambda w, h: made.append((w, h)) or real(w, h))
    monkeypatch.setattr(RO, "BAND_ELEMS", 3 * 64 * 32 * 3)
    prog = P.PROGRAMS[name](px=64)
    fn = prog.build(DeviceGroup("cpu", device="cpu"))
    two_d = prog.work_region.ndim == 2
    got = fn(8, 16, 4, 40) if two_d else fn(2, 4)
    assert made == [(64, 64)]                # at build time only
    scene = {k: torch.from_numpy(v) for k, v in RR.make_scene(
        int(name[3])).items()}
    want = (RR.render_rows(scene, 8, 16, 64, 64, 4, 40) if two_d
            else RR.render_rows(scene, 8, 16, 64, 64).reshape(-1, 3))
    assert torch.equal(got, want)


def test_ray_band_budget_bounds_the_temporaries():
    rows = RO._band_rows(4096, 32)
    assert rows * 4096 * 32 * 3 <= RO.BAND_ELEMS
    assert RO._band_rows(4096, 32) >= 1 and RO._band_rows(10 ** 9, 32) == 1


# ------------------------------------------------- 2-D inside the port

@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("name", list(SIZES))
def test_coexec_equals_reference_exactly(name, sched):
    kw = {"n_packets": 8} if sched == "dynamic" else {}
    res = coexec(P.PROGRAMS[name](**SIZES[name]), devices3(),
                 scheduler=sched, scheduler_kwargs=kw)
    np.testing.assert_array_equal(res.output, port_ref(name))
    assert res.aborted_devices == 0
    if name.endswith("2d"):
        assert all(p.region is not None and p.region.ndim == 2
                   for p in res.packets)


@pytest.mark.parametrize("name", list(SIZES))
def test_host_groups_run_the_compiled_routines(name):
    """Every packet of a host group goes through the program's compiled
    host routine (``host_calls``); no card kernel launches."""
    mod = {"gaussian2d": KG, "mandelbrot2d": KM}.get(name, RO)
    before = mod.host_calls
    res = coexec(P.PROGRAMS[name](**SIZES[name]), devices3(),
                 scheduler="dynamic", scheduler_kwargs={"n_packets": 8})
    assert mod.host_calls - before >= len(res.packets) > 0
    assert getattr(mod, "launches", 0) == 0


@pytest.mark.parametrize("name,roi", [
    ("gaussian2d", Region.rect(32, 48, lws=(16, 8), offset=(16, 8))),
    ("mandelbrot2d", Region.rect(16, 24, lws=(8, 8), offset=(8, 16))),
    ("ray1_2d", Region.rect(20, 12, lws=(4, 4), offset=(40, 4))),
    ("ray2_2d", Region.rect(64, 8, lws=(4, 4), offset=(0, 56)))])
def test_roi_reoffload_equals_the_slice_of_the_reference(name, roi):
    """register_workload pays init once; ROI-mode submits of a sub-region
    then equal the matching block of the full reference, exactly, and
    binary-mode submits of the same region pay init every time."""
    prog = P.PROGRAMS[name](**SIZES[name])
    d0, d1 = roi.dims
    oc = prog.out_cols
    want = port_ref(name)[d0.offset:d0.offset + d0.size,
                          d1.offset * oc:(d1.offset + d1.size) * oc]
    with EngineSession(devices3()) as session:
        session.register_workload(prog)
        assert session.init_payments == 3
        for _ in range(2):
            r = session.submit(prog, region=roi,
                               mode=OffloadMode.ROI).result()
            np.testing.assert_array_equal(r.output, want)
        assert session.init_payments == 3
        session.unregister_workload(prog.name)
        for k in (1, 2):
            r = session.submit(prog, region=roi,
                               mode=OffloadMode.BINARY).result()
            np.testing.assert_array_equal(r.output, want)
            assert session.init_payments == 3 + 3 * k


def test_2d_region_validation():
    prog = P.PROGRAMS["gaussian2d"](**SIZES["gaussian2d"])
    with EngineSession(devices3()) as session:
        with pytest.raises(ValueError, match="not contained"):
            session.submit(prog, region=Region.rect(256, 96, lws=(16, 8)))
        with pytest.raises(ValueError, match="lws-aligned"):
            session.submit(prog, region=Region.rect(16, 8, lws=(16, 8),
                                                    offset=(8, 8)))


# --------------------------------------------------------- run journal

def _append_all(journal_cls, path):
    with journal_cls(path) as j:
        j.append_packet("k", 0, 2, np.arange(8, dtype=np.float32))
        j.append_packet("k", 2, 2, np.arange(8, 16, dtype=np.float32))
        j.append_packet("m", 0, 1, np.arange(6, dtype=np.int32)
                        .reshape(2, 3))
    return path


def _records(recs):
    return {k: [(r.key, r.offset, r.size, r.data.dtype.str,
                 r.data.shape, r.data.tobytes()) for r in v]
            for k, v in recs.items()}


def test_journal_bytes_and_reads_identical_across_packages(tmp_path):
    mine = _append_all(RunJournal, os.path.join(tmp_path, "torch.journal"))
    theirs = _append_all(JC.RunJournal, os.path.join(tmp_path, "jax.journal"))
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        assert _records(RunJournal.read(path)) == _records(
            JC.RunJournal.read(path))
    t_mine = RunJournal.truncate_packets(mine, 2)
    t_theirs = JC.RunJournal.truncate_packets(theirs, 2)
    with open(t_mine, "rb") as a, open(t_theirs, "rb") as b:
        assert a.read() == b.read()


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = _append_all(RunJournal, os.path.join(tmp_path, "j.journal"))
    recs = RunJournal.read(path)
    assert sorted(recs) == ["k", "m"]
    assert [(r.offset, r.size) for r in recs["k"]] == [(0, 2), (2, 2)]
    assert np.array_equal(recs["k"][1].data,
                          np.arange(8, 16, dtype=np.float32))
    # torn tail: the last record is dropped, the committed prefix kept
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 3)
    recs = RunJournal.read(path)
    assert [(r.offset, r.size) for r in recs["k"]] == [(0, 2), (2, 2)]
    assert "m" not in recs
    assert RunJournal.read(os.path.join(tmp_path, "nope")) == {}
    bad = os.path.join(tmp_path, "bad")
    with open(bad, "wb") as fh:
        fh.write(b"NOPE")
    with pytest.raises(ValueError, match="not a run journal"):
        RunJournal.read(bad)


def test_truncate_packets(tmp_path):
    path = os.path.join(tmp_path, "j.journal")
    with RunJournal(path) as j:
        for i in range(4):
            j.append_packet("k", 2 * i, 2, np.full(4, i, dtype=np.float32))
    recs = RunJournal.read(RunJournal.truncate_packets(path, 2))["k"]
    assert [(r.offset, r.size) for r in recs] == [(0, 2), (2, 2)]
    assert merge_spans(recs) == [(0, 4)]


@pytest.mark.parametrize("name", ["gaussian2d", "ray1"])
@pytest.mark.parametrize("keep_frac", [0.0, 0.4, 1.0])
def test_resume_reexecutes_exactly_the_gaps(tmp_path, name, keep_frac):
    """Kill a journaled run at a packet boundary (truncate its journal);
    the resume replays the committed spans, re-executes only the gaps,
    and stitches the reference output exactly."""
    prog = P.PROGRAMS[name](**SIZES[name])
    path = os.path.join(tmp_path, "run.journal")
    with EngineSession(devices3(), scheduler="dynamic",
                       scheduler_kwargs={"n_packets": 8}) as session:
        with RunJournal(path) as j:
            session.submit(prog, journal=j, cache=False).result()
        records = RunJournal.read(path)[prog.name]
        keep = int(round(keep_frac * len(records)))
        trunc = RunJournal.truncate_packets(path, keep)
        with RunJournal(trunc) as j2:
            rep = resume_run(session, prog, j2, prog.name, cache=False)
    committed = merge_spans(records[:keep])
    for ga, gb in rep.gaps:
        for ca, cb in committed:
            assert gb <= ca or ga >= cb
    assert rep.replayed_wg == sum(b - a for a, b in committed)
    assert rep.replayed_wg + rep.executed_wg == prog.total_work
    assert rep.executed_wg == sum(b - a for a, b in rep.gaps)
    assert rep.fully_replayed == (keep == len(records))
    np.testing.assert_array_equal(rep.output, port_ref(name))
