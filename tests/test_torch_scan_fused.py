"""The fused selective scan (Mamba's discretisation taken into the scan):
the port's plain ``selective_scan_fused`` against the JAX package's
discretisation (``models/layers.py:608-611``) followed by its model scan
``_ssm_scan_chunked`` (``:559``), and the plain backward
``selective_scan_fused_bwd_ref`` against ``jax.vjp`` of the same JAX
function and against torch autograd of the plain forward.  Inputs are
made with numpy from a seed, at small sizes.

Tolerances: the forward at rtol 1e-4 / atol 1e-5, that of
``tests/test_kernels.py:152``; the backward at rtol 1e-5 / atol 1e-6, that
of ``tests/test_torch_scan_bwd.py`` (float32 on both sides, in other orders
of operations).  In bfloat16 dt and x the two sides take the same bfloat16
values and compute in float32; d_dt and d_x are rounded to bfloat16 at the
end, so those two may differ by one bfloat16 step (at most 2^-7 of the
value) where the float32 sums round to neighbours.

The tests marked ``cuda`` hold the fused kernels against the plain
versions on a card, and skip without one.  JAX is imported inside the
tests that use it, so the file also runs where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import kernel as KS, ref as RS
from repro_torch.launch import op_cost

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_CHUNK = 16          # S = 37 and 100 are not multiples: one whole chunk
DI = 6
NAMES = ("d_dt", "d_x", "dA", "dB", "dC", "dh0")


def _inputs(B, S, di, ds, seed, dtype="float32"):
    """dt in [0.01, 0.5), A = -(1 .. ds) per channel as the model makes
    it, x, B, C, dy, h0 and dhT standard normal; dt and x rounded to
    ``dtype`` (their values exact in it), the rest float32."""
    rng = np.random.default_rng(seed)
    A_log = np.log(np.arange(1, ds + 1, dtype=np.float32))
    arrays = dict(
        dt=rng.uniform(0.01, 0.5, (B, S, di)),
        x=rng.standard_normal((B, S, di)),
        A=-np.exp(np.tile(A_log, (di, 1))),
        B=rng.standard_normal((B, S, ds)),
        C=rng.standard_normal((B, S, ds)),
        dy=rng.standard_normal((B, S, di)),
        h0=rng.standard_normal((B, di, ds)),
        dhT=rng.standard_normal((B, di, ds)))
    out = {k: v.astype(np.float32) for k, v in arrays.items()}
    if dtype == "bfloat16":
        for k in ("dt", "x"):
            out[k] = torch.from_numpy(out[k]).bfloat16().float().numpy()
    return out


def _torch(x, dtype="float32", with_h0=True, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    for k in ("dt", "x"):
        t[k] = t[k].to(getattr(torch, dtype))
    if not with_h0:
        t["h0"] = t["dhT"] = None
    return t


def _jax_fused(dtype):
    """The JAX package's discretisation (``models/layers.py:608-611``)
    and model scan, as a function of (dt, x, A, B, C, h0)."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    def fused(dt, x, A, B, C, h0):
        dt32 = dt.astype(jnp.float32)
        a = jnp.exp(dt32[..., None] * A)
        b = (dt32 * x.astype(jnp.float32))[..., None] * B[:, :, None, :]
        return JL._ssm_scan_chunked(a, b, C, h0, JAX_CHUNK)
    return fused


def _jax_args(x, dtype):
    import jax.numpy as jnp
    jt = getattr(jnp, dtype)
    return (jnp.asarray(x["dt"], jt), jnp.asarray(x["x"], jt),
            *(jnp.asarray(x[k]) for k in ("A", "B", "C", "h0")))


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("S,ds", [(1, 16), (7, 8), (16, 16), (37, 32),
                                  (64, 16), (100, 8)])
def test_plain_fused_matches_jax_discretisation_and_scan(S, ds, with_h0,
                                                         dtype):
    x = _inputs(2, S, DI, ds, seed=S * 10 + ds, dtype=dtype)
    if not with_h0:
        x["h0"] = np.zeros_like(x["h0"])
    t = _torch(x, dtype, with_h0)
    y, h = RS.selective_scan_fused(t["dt"], t["x"], t["A"], t["B"], t["C"],
                                   t["h0"])
    yj, hj = _jax_fused(dtype)(*_jax_args(x, dtype))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **FWD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)


def test_plain_fused_is_the_eager_discretisation_then_the_scan():
    """The plain version is the model's eager lines: a and b formed as
    planes, then the plain scan, bitwise."""
    t = _torch(_inputs(2, 20, DI, 16, seed=1), "bfloat16")
    dt32 = t["dt"].float()
    a = torch.exp(dt32[..., None] * t["A"])
    b = (dt32 * t["x"].float())[..., None] * t["B"][:, :, None, :]
    want = RS.selective_scan(a, b, t["C"], t["h0"])
    got = RS.selective_scan_fused(t["dt"], t["x"], t["A"], t["B"], t["C"],
                                  t["h0"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_empty_sequence_returns_the_carried_state(with_h0):
    t = _torch(_inputs(2, 0, DI, 8, seed=2), with_h0=with_h0)
    y, h = KS.selective_scan_fused(t["dt"], t["x"], t["A"], t["B"], t["C"],
                                   t["h0"])
    assert y.shape == (2, 0, DI)
    want = t["h0"] if with_h0 else torch.zeros(2, DI, 8)
    assert torch.equal(h, want)


# -------------------------------------------------------------- backward
def _port_bwd(t):
    return RS.selective_scan_fused_bwd_ref(t["dt"], t["x"], t["A"], t["B"],
                                           t["C"], t["h0"], t["dy"],
                                           t["dhT"])


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("S,ds", [(1, 16), (7, 8), (16, 32), (37, 16),
                                  (100, 8)])
def test_plain_fused_backward_matches_jax_vjp(S, ds, with_h0):
    import jax
    import jax.numpy as jnp
    x = _inputs(2, S, DI, ds, seed=S * 7 + ds)
    if not with_h0:
        x["h0"] = np.zeros_like(x["h0"])
        x["dhT"] = np.zeros_like(x["dhT"])
    got = _port_bwd(_torch(x, with_h0=with_h0))
    _, vjp = jax.vjp(_jax_fused("float32"), *_jax_args(x, "float32"))
    want = vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dhT"])))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,ds", [(1, 16), (37, 8), (64, 32)])
def test_plain_fused_backward_matches_autograd_of_plain_forward(S, ds,
                                                                dtype):
    """What training takes on the host (autograd through the plain fused
    forward) and the plain version of the backward kernel give one
    gradient; in bfloat16, d_dt and d_x within one bfloat16 step."""
    x = _inputs(2, S, DI, ds, seed=3 * S + ds, dtype=dtype)
    t = _torch(x, dtype)
    leaves = {k: t[k].clone().requires_grad_()
              for k in ("dt", "x", "A", "B", "C", "h0")}
    y, h = RS.selective_scan_fused(*leaves.values())
    grads = torch.autograd.grad((y * t["dy"]).sum() + (h * t["dhT"]).sum(),
                                tuple(leaves.values()))
    got = _port_bwd(t)
    for name, g, w in zip(NAMES, got, grads):
        assert g.dtype == w.dtype, name
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=2 ** -7, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                       **BWD_TOL)


def test_empty_sequence_backward_passes_dhT_to_dh0():
    t = _torch(_inputs(2, 0, DI, 8, seed=4))
    d_dt, d_x, dA, dB, dC, dh0 = _port_bwd(t)
    assert d_dt.shape == d_x.shape == (2, 0, DI)
    assert dB.shape == dC.shape == (2, 0, 8)
    assert torch.equal(dA, torch.zeros(DI, 8))
    assert torch.equal(dh0, t["dhT"])


def test_wrappers_take_the_plain_versions_on_the_host():
    """On CPU tensors the wrappers are the plain versions, bitwise, and
    launch nothing; without ``need_dA`` dA is None."""
    t = _torch(_inputs(2, 21, DI, 16, seed=5), "bfloat16")
    before = (KS.fused_launches, KS.fused_bwd_launches, KS.launches,
              KS.bwd_launches)
    args = (t["dt"], t["x"], t["A"], t["B"], t["C"], t["h0"])
    for g, w in zip(KS.selective_scan_fused(*args),
                    RS.selective_scan_fused(*args)):
        assert torch.equal(g, w)
    got = KS.selective_scan_fused_bwd(*args, t["dy"], t["dhT"])
    for g, w in zip(got, _port_bwd(t)):
        assert torch.equal(g, w)
    assert KS.selective_scan_fused_bwd(*args, t["dy"], need_dA=False)[2] \
        is None
    assert before == (KS.fused_launches, KS.fused_bwd_launches, KS.launches,
                      KS.bwd_launches)


# ------------------------------------------------------------ on meta
def test_meta_fakes_give_the_fused_kernels_shapes_and_tally():
    """On ``meta`` tensors (a plan) the fused wrappers make only what the
    kernels make and tally their least operations and bytes; autograd
    records the fused backward; nothing launches."""
    m = "meta"
    Bn, S, di, ds = 2, 50, 64, 16
    dt = torch.empty(Bn, S, di, dtype=torch.bfloat16, device=m)
    A = torch.empty(di, ds, device=m)
    Bm = torch.empty(Bn, S, ds, device=m)
    h0 = torch.empty(Bn, di, ds, device=m)
    counts = (KS.fused_launches, KS.fused_bwd_launches, KS.launches,
              KS.bwd_launches)
    with op_cost.OpCost() as oc:
        y, h, st = KS.selective_scan_fused_fwd(dt, dt, A, Bm, Bm, h0,
                                               keep_states=True)
    assert (y.shape, h.shape, st.shape) == ((Bn, S, di), (Bn, di, ds),
                                           (Bn, 4, di, ds))
    assert y.dtype == torch.float32 and y.device.type == m
    cost = oc.kernels["selective_scan_fused"]
    assert cost["flops"] == 6.0 * Bn * S * di * ds
    assert cost["transcendentals"] == Bn * S * di * ds
    assert cost["bytes"] == (2.0 * 2 * Bn * S * di + 4.0 * (
        di * ds + 2 * Bn * S * ds + Bn * S * di + 2 * Bn * di * ds
        + st.numel()))
    out = KS.selective_scan_fused_bwd(dt, dt, A, Bm, Bm, h0, y, None, st)
    assert [o.shape for o in out] == [dt.shape, dt.shape, A.shape, Bm.shape,
                                      Bm.shape, h0.shape]
    assert out[0].dtype == torch.bfloat16
    leaves = [t.clone().requires_grad_() for t in (dt, dt, A, Bm, Bm)]
    yg, _ = KS.selective_scan_fused(*leaves, None)
    grads = torch.autograd.grad(yg.sum(), leaves)
    assert [g.shape for g in grads] == [t.shape for t in leaves]
    assert counts == (KS.fused_launches, KS.fused_bwd_launches,
                      KS.launches, KS.bwd_launches)      # none launched


class _PlaneWatch(torch.utils._python_dispatch.TorchDispatchMode):
    """Names the ops whose result is a (B, S, di, ds) plane (the kept
    states, (B, ceil(S / 16), di, ds), are not one)."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.planes = tuple(shape), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in op_cost._tensors(out):
            if tuple(t.shape) == self.shape:
                self.planes.append(str(func))
        return out


PLANE = (2, 24)         # the Mamba layer's batch and sequence


def _mamba_step(device, dtype):
    """A smoke falcon-mamba-7b layer's forward and backward on
    ``device``."""
    from dataclasses import replace

    from repro_torch.configs import get_smoke
    from repro_torch.models import layers as L
    cfg = replace(get_smoke("falcon-mamba-7b"), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    p = L.mamba_init(cfg, gen, getattr(torch, dtype)).to(device)
    x = torch.randn(PLANE[:2] + (cfg.d_model,), generator=gen).to(
        device, getattr(torch, dtype)).requires_grad_()

    def run():
        y, _ = L.mamba_apply(cfg, p, x)
        torch.autograd.grad(y.float().sum(), [x] + [
            t for t in p.parameters() if t.requires_grad])
    return PLANE[:2] + (cfg.d_inner, cfg.ssm.d_state), run


def test_mamba_layer_forms_no_plane_in_a_plan():
    """On ``meta`` (the card's path in a plan) the Mamba layer's prefill
    and training run the fused kernels and form no (B, S, di, ds) tensor,
    forward or backward."""
    plane, run = _mamba_step("meta", "bfloat16")
    watch = _PlaneWatch(plane)
    with watch:
        run()
    assert watch.planes == []


# ------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,ds,with_h0", [
    (2, 128, 64, 16, False),
    (1, 1000, 1000, 8, True),       # ragged S and di, a carried state
    (2, 37, 100, 5, True),          # ds not a power of two
    (1, 19, 64, 32, False),         # a whole warp per channel
    (3, 8, 33, 1, True),
    (2, 0, 16, 16, True),           # no steps: h_T is h0
])
def test_fused_kernels_match_plain_on_card(card, B, S, di, ds, with_h0,
                                           dtype):
    """Forward at the forward's tolerance; backward, fed the kept states,
    each output within 1e-4 of its largest |value| + 1e-5 (and one
    bfloat16 step in d_dt and d_x), two calls bitwise equal."""
    t = _torch(_inputs(B, S, di, ds, seed=B + S + di, dtype=dtype), dtype,
               with_h0, device=card)
    args = (t["dt"], t["x"], t["A"], t["B"], t["C"], t["h0"])
    before = KS.fused_launches
    y, h, st = KS.selective_scan_fused_fwd(*args, keep_states=True)
    torch.cuda.synchronize()
    assert KS.fused_launches == before + 1
    yr, hr = RS.selective_scan_fused(*args)
    torch.testing.assert_close(y, yr, **FWD_TOL)
    torch.testing.assert_close(h, hr, **FWD_TOL)
    got = KS.selective_scan_fused_bwd(*args, t["dy"], t["dhT"], st)
    again = KS.selective_scan_fused_bwd(*args, t["dy"], t["dhT"], st)
    want = RS.selective_scan_fused_bwd_ref(*args, t["dy"], t["dhT"])
    for name, g, r, w in zip(NAMES, got, again, want):
        assert torch.equal(g, r), name
        g, w = g.float(), w.float()
        top = float(w.abs().max()) if w.numel() else 0.0
        slack = 2 ** -7 * w.abs() if name in ("d_dt", "d_x") and \
            dtype == "bfloat16" else 0.0
        assert bool(((g - w).abs() <= 1e-4 * top + 1e-5 + slack).all()), name


@pytest.mark.cuda
def test_mamba_layer_forms_no_plane_on_card(card):
    """On the card the Mamba layer's prefill and training launch the
    fused kernels (one forward, one backward) and form no (B, S, di, ds)
    tensor."""
    plane, run = _mamba_step(card.type, "float32")
    watch = _PlaneWatch(plane)
    before = (KS.fused_launches, KS.fused_bwd_launches, KS.launches)
    with watch:
        run()
    torch.cuda.synchronize()
    assert watch.planes == []
    assert (KS.fused_launches - before[0], KS.fused_bwd_launches - before[1],
            KS.launches - before[2]) == (1, 1, 0)
