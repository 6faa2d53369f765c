"""The PyTorch port's main path on the CPU: ``repro_torch.api.coexec``
co-executes the paper's four kernel programs on a fleet of three throttled
host groups (``device="cpu"``, as in tests/test_coexec.py) and must agree
with the JAX package's ``reference_output``; plus the port's guards."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import programs as JP
from repro_torch.api import (DevicePolicy, EngineSession, OffloadMode,
                             Region, coexec)
from repro_torch.core import programs as P
from repro_torch.core.device import DeviceGroup, reserve_feeder_cores
from repro_torch.tune import TunedConfig

SRC = Path(__file__).resolve().parents[1] / "src"

SIZES = {
    "gaussian": dict(h=1024, w=64),
    "binomial": dict(n_options=4096),
    "mandelbrot": dict(px=64, max_iter=64),
    "nbody": dict(n_bodies=512),
}
# against the JAX package: those of tests/test_kernels.py, binomial at its
# kernel test's (the two frameworks' exp and FMA contraction differ in the
# last bits, ~3e-4 absolute after 254 steps); mandelbrot exactly at 64 px
TOL = {"gaussian": (1e-5, 1e-5), "binomial": (1e-4, 1e-3),
       "nbody": (2e-4, 2e-4)}
SCHEDULERS = ["static", "static_rev", "dynamic", "hguided", "hguided_opt"]


def devices3():
    return [DeviceGroup("cpu", device="cpu", throttle=3.0),
            DeviceGroup("igpu", device="cpu", throttle=1.5),
            DeviceGroup("gpu", device="cpu", throttle=1.0)]


_JAX_REFS = {}


def jax_ref(name):
    if name not in _JAX_REFS:
        _JAX_REFS[name] = JP.reference_output(name, **SIZES[name])
    return _JAX_REFS[name]


def assert_matches(name, out, ref):
    assert out.shape == ref.shape
    if name == "mandelbrot":
        np.testing.assert_array_equal(out, ref)
    else:
        rtol, atol = TOL[name]
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("name", list(SIZES))
def test_coexec_matches_jax_reference(name, sched):
    kw = {"n_packets": 8} if sched == "dynamic" else {}
    res = coexec(P.PROGRAMS[name](**SIZES[name]), devices3(),
                 scheduler=sched, scheduler_kwargs=kw)
    assert_matches(name, res.output, jax_ref(name))
    # inside the port every fleet gives the single-packet output exactly
    ref = P.reference_output(name, device="cpu", **SIZES[name])
    np.testing.assert_array_equal(res.output, ref)
    assert res.aborted_devices == 0
    assert res.total_time > 0 and res.binary_time >= res.total_time


def test_device_failure_absorbed():
    prog = P.PROGRAMS["gaussian"](**SIZES["gaussian"])
    devs = devices3()
    devs[2].fail_after = 0          # the fastest group dies on its packet
    res = coexec(prog, devs, scheduler="static")
    assert res.aborted_devices == 1 and devs[2].dead
    assert res.retries >= 1
    assert_matches("gaussian", res.output, jax_ref("gaussian"))


def test_all_devices_fail_raises():
    devs = devices3()
    for d in devs:
        d.fail_after = 0
    with pytest.raises(RuntimeError):
        coexec(P.PROGRAMS["gaussian"](h=256, w=64), devs,
               scheduler="dynamic", scheduler_kwargs={"n_packets": 8})


def test_roi_reoffload_through_pooled_pipeline():
    """register_workload pays init once; ROI-mode submits then run warm
    sub-regions through BufferPolicy.POOLED and the pipelined loop."""
    prog = P.PROGRAMS["binomial"](**SIZES["binomial"])
    ref = jax_ref("binomial")
    G = prog.total_work
    with EngineSession(devices3()) as session:
        session.register_workload(prog)
        assert session.init_payments == 3
        for off, size in ((G // 2, G // 4), (0, G // 8), (0, G)):
            res = session.submit(prog, region=Region.line(size, offset=off),
                                 mode=OffloadMode.ROI).result()
            want = ref[off * 128:(off + size) * 128]
            assert_matches("binomial", res.output, want)
        assert session.init_payments == 3


def test_per_packet_dispatch_and_elastic_membership():
    prog = P.PROGRAMS["nbody"](**SIZES["nbody"])
    ref = jax_ref("nbody")
    with EngineSession(devices3()[:2], dispatch="per_packet") as session:
        assert_matches("nbody", session.run(prog).output, ref)
        session.add_device(DeviceGroup("late", device="cpu"))
        r2 = session.run(prog)
        assert len(r2.device_busy) == 3
        assert_matches("nbody", r2.output, ref)


# ------------------------------------------------------------------ guards
def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.api, repro_torch.core.programs\n"
            "import repro_torch.ckpt.checkpoint, repro_torch.tune\n"
            "import repro_torch.core.simulate\n"
            "import repro_torch.configs.paper_suite\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == ""


def test_no_cuda_means_no_silent_cpu_fleet(monkeypatch):
    """Without CUDA, device discovery and the card's reference raise:
    nothing falls back to running on the host CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = P.PROGRAMS["binomial"](**SIZES["binomial"])
    with pytest.raises(RuntimeError, match="CUDA"):
        coexec(prog)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePolicy().discover()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.reference_output("binomial", **SIZES["binomial"])


def test_device_defaults_to_cuda():
    assert DeviceGroup("g").device == torch.device("cuda")
    assert DeviceGroup("h", device="cpu").device == torch.device("cpu")


def test_tuned_config_is_applied():
    """``tuned=`` sets the run's scheduler, its kwargs, the lease constants
    and the transfer crossover; explicit kwargs still win."""
    cfg = TunedConfig(scheduler="dynamic", scheduler_kwargs={"n_packets": 8},
                      lease_overhead_s=1e-4, lease_overhead_frac=0.05,
                      lease_k_max=16, async_threshold_bytes=1 << 12)
    with EngineSession(devices3(), tuned=cfg) as s:
        assert (s.scheduler, s.scheduler_kwargs) == ("dynamic",
                                                     {"n_packets": 8})
        assert s.lease_params == cfg.lease_params()
        assert s.async_threshold_bytes == 1 << 12
        res = s.run(P.PROGRAMS["binomial"](**SIZES["binomial"]))
    assert_matches("binomial", res.output, jax_ref("binomial"))
    with EngineSession(devices3(), tuned=cfg, scheduler="static") as s:
        assert (s.scheduler, s.scheduler_kwargs) == ("static", {})


def test_mixed_fleet_leaves_a_core_per_card():
    before = torch.get_num_threads()
    try:
        reserve_feeder_cores(devices3())           # host only: unchanged
        assert torch.get_num_threads() == before
        reserve_feeder_cores([DeviceGroup("cuda0", device="cuda:0"),
                              DeviceGroup("cpu", device="cpu")])
        assert torch.get_num_threads() == max(1, (os.cpu_count() or 1) - 1)
    finally:
        torch.set_num_threads(before)
