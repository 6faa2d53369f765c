"""Plain PyTorch versions of causal GQA attention and of its gradient:
exact, with the scores materialised.  ``attention_ref`` transcribes the
JAX package's oracle (``kernels/flash_attention/ref.py``) op for op;
``attention_lse_ref`` is the log-sum-exp that the forward kernel keeps
for the backward, and ``attention_bwd_ref`` the plain version of the
backward kernel (``csrc/flash_attention_bwd.cu``).

Each takes ``q_start``: query row i sits at key position ``q_start`` + i
and the keys run from 0 to ``q_start`` + Sq (k and v hold Sk = q_start +
Sq rows), the causal mask aligned at the rectangle's bottom right: the
rows of a stretch of positions whose earlier keys are at hand.

And each takes ``score_dtype``.  At float32 the scores, the softmax and
the value sum are float32.  At bfloat16 the functions transcribe the JAX
package's ``_flash_inner`` / ``blocked_causal_attention``
(``models/layers.py:73-139``) op for op: q, k and v cast to bfloat16, the
scores bf16(bf16(q.k) * bf16(scale)), the diagonal chunk masked with -60000,
the weights p = exp(s - m) rounded to bfloat16 against the running max
m of each ``chunk`` of keys, the chunk's sum of p in bfloat16, and m, the
denominator and the accumulator in float32; the query blocks are the
chunks at global positions.  Where ``chunk`` does not divide the keys the
JAX schedule takes them all as one chunk; with ``ragged`` the last chunk
is short instead, as the kernels' key tiles are, so that p is rounded
against the running max that the kernels round it against."""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
BF16_MASK = -60000.0    # the JAX package's bfloat16 mask value


def is_bf16(score_dtype) -> bool:
    """Whether ``score_dtype`` ("float32" or "bfloat16", or the torch
    dtype) keeps the scores in bfloat16."""
    if score_dtype in ("float32", torch.float32):
        return False
    if score_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise ValueError(f"score_dtype {score_dtype!r}: float32 or bfloat16")


def _causal(Sq: int, Sk: int, q_start: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key t at or before query row i's position."""
    if q_start + Sq != Sk or q_start < 0:
        raise ValueError(f"keys {Sk} != q_start {q_start} + queries {Sq}")
    return torch.ones((Sq, Sk), dtype=torch.bool,
                      device=device).tril(diagonal=q_start)


def _chunk(chunk, Sk: int, ragged: bool = False) -> int:
    """The JAX schedule's kv-block size for Sk keys: ``chunk`` capped at
    Sk, the whole range where it does not divide Sk (unless ``ragged``:
    the last block is then short)."""
    c = min(chunk or Sk, Sk)
    return Sk if Sk % c and not ragged else c


def _bf16_scores(qg, k):
    """bf16(bf16(q.k) * scale) of qg (..., T, KH, G, D) against k (B, C,
    KH, D): (B, T, KH, G, C), the products of the bfloat16 values summed
    in float32 and rounded once, then scaled and rounded again; the scale
    is a bfloat16, as the JAX package's weakly typed constant becomes."""
    s = torch.einsum("btkgd,bckd->btkgc", qg.float(), k.float())
    scale = torch.tensor(1.0 / math.sqrt(qg.shape[-1]), dtype=torch.bfloat16)
    return s.to(torch.bfloat16) * scale


def _bf16_flash(q, k, v, q_start: int, chunk, ragged: bool = False):
    """The JAX package's bfloat16 chunk loop: returns (out (B,Sq,H,D_v)
    float32, m and l (B, Sq, KH, G) float32, the last chunk's running max
    and denominator)."""
    B, Sq, H, D = q.shape
    Sk, KH, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    _causal(Sq, Sk, q_start, q.device)
    c = _chunk(chunk, Sk, ragged)
    bf = torch.bfloat16
    qf = q.reshape(B, Sq, KH, G, D).to(bf)
    kf, vf = k.to(bf), v.to(bf)
    neg = torch.tensor(BF16_MASK, dtype=bf, device=q.device)
    outs, ms, ls = [], [], []
    for j in range(q_start // c, (Sk + c - 1) // c):
        lo, hi = max(j * c, q_start), min((j + 1) * c, Sk)
        qj = qf[:, lo - q_start:hi - q_start]
        T = hi - lo
        m = torch.full((B, T, KH, G), float("-inf"), device=q.device)
        l = torch.zeros((B, T, KH, G), device=q.device)
        acc = torch.zeros((B, T, KH, G, DV), device=q.device)
        for i in range(j + 1):
            s = _bf16_scores(qj, kf[:, i * c:(i + 1) * c])
            if i == j:   # the diagonal chunk: key position <= row's
                tri = (torch.arange(i * c, i * c + s.shape[-1],
                                    device=q.device)[None, :]
                       <= torch.arange(lo, hi, device=q.device)[:, None])
                s = torch.where(tri[None, :, None, None, :], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            p = torch.exp(s.float() - m_new[..., None]).to(bf)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1).float()
            acc = acc * corr[..., None] + torch.einsum(
                "btkgc,bckd->btkgd", p.float(),
                vf[:, i * c:(i + 1) * c].float())
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, DV)
    return out, torch.cat(ms, dim=1), torch.cat(ls, dim=1)


def attention_ref(q, k, v, *, q_start: int = 0, score_dtype="float32",
                  chunk=None, ragged: bool = False):
    """q: (B,Sq,H,D); k: (B,Sk,KH,D); v: (B,Sk,KH,D_v) with H % KH == 0
    and Sk = q_start + Sq -> (B,Sq,H,D_v) in q's dtype; at float32 scores
    the scores, softmax and value sum in float32, at bfloat16 the JAX
    package's chunk loop over ``chunk`` keys (``ragged``: the module's
    docstring)."""
    if is_bf16(score_dtype):
        return _bf16_flash(q, k, v, q_start, chunk, ragged)[0].to(q.dtype)
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s / math.sqrt(D)
    mask = _causal(Sq, k.shape[1], q_start, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _scores(q, k, q_start: int = 0, bf16: bool = False):
    """The scaled causal scores, float32 (B, KH, G, Sq, Sk), -inf above
    the diagonal; with ``bf16`` the kernels' bfloat16 scores
    bf16(bf16(q.k) * scale) of q and k rounded to bfloat16."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D)
    if bf16:
        s = _bf16_scores(qg.to(torch.bfloat16), k.to(torch.bfloat16))
        s = s.float().permute(0, 2, 3, 1, 4)
    else:
        s = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                         k.float()) / math.sqrt(D)
    return s.masked_fill(~_causal(Sq, Sk, q_start, q.device), float("-inf"))


def attention_lse_ref(q, k, v, *, q_start: int = 0, score_dtype="float32",
                      chunk=None, ragged: bool = False):
    """Each query row's log-sum-exp of its scaled causal scores, in base
    2: log2 sum_t exp(q.k_t / sqrt(D)) over keys t <= the row's position,
    what the forward kernel writes for the backward.  q: (B,Sq,H,D); k, v:
    (B,Sk,KH,D) (v is not read but at bfloat16: the arguments are the
    forward's) -> float32 (B, H, Sq).  At bfloat16 scores, m log2 e +
    log2 l of the JAX package's chunk loop."""
    B, Sq, H, _ = q.shape
    if is_bf16(score_dtype):
        _, m, l = _bf16_flash(q, k, v, q_start, chunk, ragged)
        lse = m * LOG2E + torch.log2(l.clamp_min(1e-30))   # (B,Sq,KH,G)
        return lse.reshape(B, Sq, H).transpose(1, 2).contiguous()
    lse = torch.logsumexp(_scores(q, k, q_start), dim=-1) * LOG2E
    return lse.reshape(B, H, Sq)


def attention_bwd_ref(q, k, v, out, dout, lse=None, *, q_start: int = 0,
                      score_dtype="float32", chunk=None,
                      bf16_products: bool = False):
    """Gradient of :func:`attention_ref` by the explicit formulas, with
    the probabilities P materialised in float32: dV = P^T dO, dP = dO V^T,
    D_i = sum_d dO*O, dS = P (dP - D_i), dQ = dS K / sqrt(D), dK = dS^T Q
    / sqrt(D).  q: (B,Sq,H,D); k: (B,Sk,KH,D); v: (B,Sk,KH,D_v); out,
    dout: (B,Sq,H,D_v) -> (dq, dk, dv) in the inputs' dtypes.  With
    ``lse`` (float32 (B, H, Sq), as :func:`attention_lse_ref` gives it) P
    is formed from it as the kernel forms it, 2^(s log2 e - lse), instead
    of by a softmax.  At bfloat16 scores the kernels' form: q, k and v
    rounded to bfloat16, s their bfloat16 scores, P = 2^(s log2 e - lse)
    with the chunk loop's ``lse`` when none is given (``chunk``), and the
    rounding passed over by the gradient.  With ``bf16_products`` P and
    dS are rounded to bfloat16 before the products that read them, as the
    bfloat16 kernels hand them to ``wgmma``."""
    B, Sq, H, D = q.shape
    KH, DV = k.shape[2], v.shape[3]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    bf16 = is_bf16(score_dtype)
    rd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (
        lambda t: t.float())
    qg = rd(q).reshape(B, Sq, KH, G, D)
    dog = dout.reshape(B, Sq, KH, G, DV).float()
    og = out.reshape(B, Sq, KH, G, DV).float()
    s = _scores(q, k, q_start, bf16)
    if bf16 and lse is None:
        lse = attention_lse_ref(q, k, v, q_start=q_start,
                                score_dtype=score_dtype, chunk=chunk)
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
            raise ValueError(f"attention_bwd_ref: lse {tuple(lse.shape)} "
                             f"{lse.dtype}, expected float32 {(B, H, Sq)}")
        p = torch.exp2(s * LOG2E - lse.reshape(B, KH, G, Sq, 1))
    pr = (lambda t: t.to(torch.bfloat16).float()) if bf16_products else (
        lambda t: t)
    dv = torch.einsum("bkgst,bskgd->btkd", pr(p), dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, rd(v))
    di = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # (B,KH,G,S,1)
    ds = pr(p * (dp - di))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, rd(k)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
