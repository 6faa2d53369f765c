"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch.
serve``) on the CPU: the framework-free copies (workload, stats,
admission) give the JAX package's results for the same seeds; the
threaded ``CoexecServer`` over CPU replicas keeps outputs
replica-invariant, sheds and degrades as the JAX server does; greedy
tokens equal the JAX ``Replica``'s on the same weights; and the port's
serving modules import neither ``jax`` nor ``repro``."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serve as JS
import repro_torch.serve as TS
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs files in parallel workers: keep torch's intra-op
    pool small while this module runs, so it does not starve the others'
    timing-sensitive threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _fields(reqs):
    return [dataclasses.astuple(r)[:4] + dataclasses.astuple(r)[5:]
            for r in reqs]


# ----------------------------------------------- framework-free copies
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_arrivals_and_requests_match_jax(kind):
    a = JS.ARRIVALS[kind](64, 40.0, np.random.default_rng(7))
    b = TS.ARRIVALS[kind](64, 40.0, np.random.default_rng(7))
    assert a == b
    ja = JS.make_requests(a, 0.5, size=3)
    tb = TS.make_requests(b, 0.5, size=3)
    assert _fields(ja) == _fields(tb)


@pytest.mark.parametrize("policy", ["shed", "degrade", "none"])
def test_admission_and_stats_match_jax(policy):
    arrivals = TS.poisson_arrivals(40, 100.0, np.random.default_rng(3))
    out = []
    for mod in (JS, TS):
        reqs = mod.make_requests(arrivals, 0.15)
        adm = mod.EdfAdmission(policy=policy, gen=8, min_gen=2,
                               round_quantum_s=0.2, unit_work=True)
        done = []
        admitted, left = adm.admit(list(reqs), 0.1, total_power=60.0,
                                   completed=done)
        for i, r in enumerate(admitted):
            r.finish = r.arrival + 0.01 * (i + 1)
            r.replica = "r0"
        st = mod.summarize(reqs, dispatch={"r0": len(admitted)})
        out.append((_fields(admitted), _fields(left), _fields(done),
                    repr(st), st.row()))
    assert out[0] == out[1]


def test_trace_round_trip_matches_jax(tmp_path):
    arrivals = TS.bursty_arrivals(20, 30.0, np.random.default_rng(5))
    reqs = TS.make_requests(arrivals, 1.0, size=2)
    for r in reqs[::3]:
        r.shed = True
    for r in reqs[1::3]:
        r.finish, r.replica = r.arrival + 0.25, "r1"
    outcome = TS.summarize(reqs)
    path = str(tmp_path / "trace.jsonl")

    class Outcome:
        requests = reqs
        stats = outcome

    assert TS.record_trace(Outcome, path) == len(reqs)
    mine = TS.TraceWorkload.load(path)
    theirs = JS.TraceWorkload.load(path)
    assert mine.arrivals() == theirs.arrivals() == arrivals
    assert _fields(mine.requests()) == _fields(theirs.requests())


# ------------------------------------------- threaded server, CPU replicas
def _smoke_serving(arch):
    cfg = get_smoke(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return cfg, params, prompts


@pytest.fixture(scope="module")
def smoke_serving():
    return _smoke_serving("llama3.2-1b")


def _replica(name, cfg, params, throttle=1.0):
    return TS.Replica(name, cfg, params, throttle=throttle, device="cpu")


def _check_replica_invariance(cfg, params, prompts):
    """Two replicas (throttles 1 and 2) and one replica alone give every
    request the same tokens."""
    scfg = TS.ServerConfig(scheduler="hguided_deadline", lws=2, gen=2,
                           policy="none")

    def run(replicas):
        reqs = TS.make_requests([0.0] * len(prompts), slo=300.0,
                                prompt_fn=lambda i: prompts[i])
        server = TS.CoexecServer(replicas, scfg)
        try:
            out = server.run(TS.RequestQueue(reqs))
        finally:
            server.close()
        assert out.stats.served == len(prompts)
        return out

    two = run([_replica("a", cfg, params),
               _replica("b", cfg, params, throttle=2.0)])
    one = run([_replica("solo", cfg, params)])
    assert set(two.results) == set(one.results)
    for rid in one.results:
        np.testing.assert_array_equal(two.results[rid], one.results[rid])
    assert sum(two.stats.dispatch.values()) == len(prompts)


def test_server_replica_invariant_outputs(smoke_serving):
    _check_replica_invariance(*smoke_serving)


def test_mamba_server_replica_invariant_outputs():
    _check_replica_invariance(*_smoke_serving("falcon-mamba-7b"))


def test_server_sheds_on_predicted_miss(smoke_serving):
    cfg, params, prompts = smoke_serving
    reqs = TS.make_requests([0.0] * len(prompts), slo=1e-3,
                            prompt_fn=lambda i: prompts[i])
    server = TS.CoexecServer(
        [_replica("a", cfg, params)],
        TS.ServerConfig(scheduler="hguided_deadline", lws=2, gen=2,
                        policy="shed"),
        initial_power={"a": 1.0})        # calibrated: 1 req/s, SLO 1 ms
    try:
        out = server.run(TS.RequestQueue(reqs))
    finally:
        server.close()
    assert out.stats.shed > 0
    assert out.stats.shed + out.stats.served == len(prompts)
    for r in out.requests:
        if r.shed:
            assert r.finish is None and r.rid not in out.results


def test_server_degrade_policy_reduces_generation(smoke_serving):
    cfg, params, prompts = smoke_serving
    reqs = TS.make_requests([0.0] * len(prompts), slo=2.0,
                            prompt_fn=lambda i: prompts[i])
    server = TS.CoexecServer(
        [_replica("a", cfg, params)],
        TS.ServerConfig(scheduler="hguided_deadline", lws=2, gen=4,
                        policy="degrade", min_gen=1),
        initial_power={"a": 2.0})        # too slow for 8 reqs x 4 tokens
    try:
        out = server.run(TS.RequestQueue(reqs))
    finally:
        server.close()
    assert out.stats.shed == 0           # degrade never drops
    assert out.stats.degraded > 0
    degraded = [r for r in out.requests if r.degraded]
    assert all(len(out.results[r.rid]) < 4 for r in degraded)


# ------------------------------------------------ tokens against the JAX
GEN = 6
# the model tests hold logits to 2e-4 (tests/test_torch_model.py); a top-2
# gap ten times wider cannot flip the greedy choice
MIN_GAP = 2e-3


def _check_greedy_against_jax(arch, prompt_seed):
    """The port's replica and the JAX replica, on the same weights, pick
    the same greedy tokens; every step's top-2 gap is checked first."""
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompts = np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got = _replica("port", cfg, params).serve(prompts, GEN)
    # the gap between the two best logits at every greedy step
    with torch.inference_mode():
        B, P = prompts.shape
        cache = T.init_cache(cfg, B, P + GEN, device="cpu")
        lg, cache = T.prefill(cfg, params, torch.from_numpy(prompts), cache)
        for i in range(GEN):
            top2 = lg[:, -1].topk(2, dim=-1).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > MIN_GAP, i
            lg, cache = T.decode_step(cfg, params,
                                      torch.from_numpy(got[:, i:i + 1]),
                                      cache, P + i)
    want = JS.Replica("jax", jcfg, jparams).serve(prompts, GEN)
    assert got.shape == (2, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_tokens_match_jax_replica():
    _check_greedy_against_jax("llama3.2-1b", 24)


def test_mamba_greedy_tokens_match_jax_replica():
    _check_greedy_against_jax("falcon-mamba-7b", 24)


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--check-invariance",
                     "--requests", "8", "--replicas", "r0:1,r1:2"])
    out = capsys.readouterr().out
    assert rc == 0 and "outputs replica-invariant: True" in out


def test_launch_serve_mamba_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                     "cpu", "--check-invariance", "--requests", "8",
                     "--replicas", "r0:1,r1:2"])
    out = capsys.readouterr().out
    assert rc == 0 and "outputs replica-invariant: True" in out


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.models.transformer\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.kernels.mamba_scan.kernel\n"
            "import repro_torch.kernels.mamba_scan.ops\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
