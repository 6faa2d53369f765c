"""Plain PyTorch version of Binomial option pricing (paper Table I:
lws=255, 4194304 samples, 1:1 buffers, 1:255 out pattern, uses local
memory).

European call priced on a recombining binomial tree with N=254 steps (so
each option's tree has lws=255 leaves, matching the OpenCL kernel that
maps one option per work-group of 255 work-items).  Transcribes the JAX
package's oracle op for op."""
from __future__ import annotations

import torch

STEPS = 254
RISKFREE = 0.02
VOLATILITY = 0.30


def price_options(s0, strike, t_years, *, steps: int = STEPS):
    """s0/strike/t_years: (n,) float32 tensors -> (n,) option values."""
    dt = t_years / steps
    vdt = VOLATILITY * torch.sqrt(dt)
    u = torch.exp(vdt)
    d = 1.0 / u
    a = torch.exp(RISKFREE * dt)
    pu = (a - d) / (u - d)
    pd = 1.0 - pu
    disc = torch.exp(-RISKFREE * dt)
    j = torch.arange(steps + 1, dtype=torch.float32, device=s0.device)
    # leaf prices: S * u^j * d^(steps-j)
    s_t = s0[:, None] * torch.exp(vdt[:, None] * (2.0 * j[None, :] - steps))
    v = torch.clamp(s_t - strike[:, None], min=0.0)
    for _ in range(steps):
        # v[:, :steps+1-i] = disc * (pd*v[:, :-1] + pu*v[:, 1:]) -- fixed
        # width with trailing garbage, masked out by construction
        vn = disc[:, None] * (pd[:, None] * v[:, :-1] + pu[:, None] * v[:, 1:])
        v = torch.cat([vn, v[:, -1:]], dim=1)
    return v[:, 0]
