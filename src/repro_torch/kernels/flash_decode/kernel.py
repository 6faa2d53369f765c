"""Wrapper of the hand-written CUDA flash-decode kernel
(``csrc/flash_decode.cu``: the live keys [0, pos] cut into splits, one
CTA per (split, kv head, batch) whose warps stream tiles of cache rows
through TMA rings in shared memory, bfloat16 products on the tensor
cores; the last CTA of a (batch, kv head) to finish merges the splits,
in the same launch), which replaces the
JAX package's Pallas kernel ``kernels/flash_decode/kernel.py``
``flash_decode``.  :func:`flash_decode_partial` is its form for a cache
split by positions across ranks: the live rows of a rank's stretch, a
float32 output and each head's log-sum-exp, which the kernel writes
beside the output.

``meta`` tensors stand for the card's in a plan (``launch/dryrun.py``):
the wrapper then makes the output and adds the kernel's least operations
and bytes to ``meta_cost``.

``launches`` counts the wrapper's launches (one kernel each) and nothing
else."""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref as R

launches = 0
meta_cost: dict = {}    # build.tally of the calls on meta tensors

SPLIT_KEYS = 64         # a split is a whole number of 64-key blocks
MAX_GROUP = 8           # query heads per kv head
MIN_SPLIT_KEYS = 1024   # keys a CTA walks before a range splits further
TILED_HEAD_DIMS = (64, 80, 128)  # bfloat16 head dims whose CTAs may cover
                                 # several kv heads

# per (device, stream): B * KH arrival counters of the splits, zeroed
# once here and left zeroed by every launch (no memset a call)
_counters: dict = {}


def _split_counters(device: torch.device, n: int):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def heads_per_cta(batch: int, kv_heads: int, sm_count: int) -> int:
    """kv heads a CTA of the bfloat16 kernel covers: 1 while the card has
    SMs to spare, else the most (8, 4 or 2, dividing ``kv_heads``) that
    still leave three quarters of the SMs a CTA, so that a CTA's tile of
    all its heads is one contiguous stretch of the cache."""
    for hc in (8, 4, 2):
        if kv_heads % hc == 0 and 4 * batch * kv_heads // hc >= 3 * sm_count:
            return hc
    return 1


def splits(batch: int, kv_heads: int, pos: int, sm_count: int,
           heads: int = 1):
    """(n_splits, keys_per_split) for keys [0, pos] with ``heads`` kv
    heads a CTA, each split a whole number of SPLIT_KEYS blocks, none
    empty.  A CTA's warps take its tiles in parallel, so a range is split
    only while each split keeps MIN_SPLIT_KEYS keys and the card has room
    for the split CTAs in one wave: merging splits costs a few dependent
    memory round trips, which a short cache does not repay."""
    n_blocks = -(-(pos + 1) // SPLIT_KEYS)
    ctas = max(batch * kv_heads // heads, 1)
    want = min(-(-n_blocks * SPLIT_KEYS // MIN_SPLIT_KEYS),
               sm_count // ctas)
    per_split = -(-n_blocks // max(1, want))
    return -(-n_blocks // per_split), per_split * SPLIT_KEYS


def _check(q, k_cache, v_cache, pos: int, what: str):
    """The kernel's argument checks for keys [0, pos]; raise on what it
    does not take."""
    cdt = k_cache.dtype
    if cdt not in (torch.float32, torch.bfloat16) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: q {q.dtype}, cache {cdt} (float32 "
                        f"or bfloat16)")
    build.check_cuda(f"{what} k_cache", k_cache, cdt, 4, meta_ok=True)
    build.check_cuda(f"{what} v_cache", v_cache, cdt, 4, meta_ok=True)
    build.check_cuda(f"{what} q", q, q.dtype, 3, meta_ok=True)
    B, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, Smax, KH, D) or v_cache.shape != k_cache.shape
            or q.device != k_cache.device or v_cache.device != q.device):
        raise ValueError(f"{what}: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    vec = 16 // k_cache.element_size()
    if (KH == 0 or H % KH or H // KH > MAX_GROUP or D > 128 or D % vec
            or not 0 <= pos < Smax):
        raise ValueError(f"{what}: H={H}, KH={KH}, D={D}, pos={pos}, "
                         f"Smax={Smax} not supported")


def _tally(q, k_cache, pos: int, out_bytes: int):
    """A ``meta`` call's least work over keys [0, pos]: every live key and
    value row read once, q read and ``out_bytes`` written."""
    B, H, D = q.shape
    KH = k_cache.shape[2]
    build.tally(meta_cost, "flash_decode", 4.0 * B * H * D * (pos + 1),
                k_cache.element_size() * 2 * B * (pos + 1) * KH * D
                + q.element_size() * B * H * D + out_bytes,
                dot_flops=4.0 * B * H * D * (pos + 1),
                transcendentals=B * H * (pos + 1))


def _launch(q, k_cache, v_cache, pos: int, out, lse=None):
    """One launch over keys [0, pos] into ``out`` (and, given, each head's
    log-sum-exp into ``lse``)."""
    global launches
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: caches must be 16-byte aligned")
    cdt = k_cache.dtype
    B, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    # cached_decode_attention casts q to the cache's type
    qc = q.to(cdt).contiguous()
    sms = _sm_count(q.device)
    hc = (heads_per_cta(B, KH, sms)
          if cdt == torch.bfloat16 and D in TILED_HEAD_DIMS else 1)
    ns, kps = splits(B, KH, pos, sms, hc)
    G = H // KH
    scratch = (None, None, None)      # one split: the CTA writes out
    if ns > 1:
        part_o = torch.empty((B, KH, ns, G, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, KH, ns, G, 2), dtype=torch.float32,
                              device=q.device)
        scratch = (part_o.data_ptr(), part_ml.data_ptr(),
                   _split_counters(q.device, B * KH).data_ptr())
    build.launch("flash_decode_fwd", q, qc.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), out.data_ptr(), *scratch,
                 None if lse is None else lse.data_ptr(), B, Smax, H,
                 KH, D, pos, ns, kps, hc, int(cdt == torch.bfloat16),
                 int(out.dtype == torch.bfloat16))
    launches += 1


def flash_decode(q, k_cache, v_cache, pos):
    """q: (B,H,D); caches: (B,Smax,KH,D) in their storage dtype (float32
    or bfloat16); ``pos`` a Python int -> (B,H,D) in q's dtype, attending
    to cache positions [0, pos].  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which reads only the live keys."""
    pos = operator.index(pos)
    if q.device.type == "cpu":
        return R.decode_attention(q, k_cache, v_cache, pos)
    _check(q, k_cache, v_cache, pos, "flash_decode")
    if q.device.type == "meta":
        _tally(q, k_cache, pos, q.numel() * q.element_size())
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k_cache, v_cache, pos, out)
    return out


def flash_decode_partial(q, k_cache, v_cache, n):
    """A rank's part of decode attention over a cache split by positions:
    q: (B,H,D); caches: (B,S,KH,D), the rank's stretch of positions in
    their storage dtype; ``n`` a Python int, its live rows [0, n) (0 for
    a rank whose stretch starts past the current position) -> (o (B,H,D)
    float32, lse (B,H) float32: each head's natural log-sum-exp of its
    scaled scores over those rows), which ``ShardedRun.combine_lse``
    joins across ranks.  ``o`` stays float32 so that the combine rounds
    once.  With ``n`` 0 nothing launches: o is 0 and lse -inf.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    writes the log-sum-exp beside o."""
    n = operator.index(n)
    if q.device.type == "cpu":
        return R.decode_attention_partial(q, k_cache, v_cache, n)
    if not 0 <= n <= k_cache.shape[1]:
        raise ValueError(f"flash_decode_partial: n={n} of "
                         f"{k_cache.shape[1]} rows")
    B, H, D = q.shape
    if n == 0:
        _check(q, k_cache, v_cache, 0, "flash_decode_partial")
        return (torch.zeros((B, H, D), dtype=torch.float32,
                            device=q.device),
                torch.full((B, H), float("-inf"), dtype=torch.float32,
                           device=q.device))
    _check(q, k_cache, v_cache, n - 1, "flash_decode_partial")
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _tally(q, k_cache, n - 1, 4 * (out.numel() + lse.numel()))
        return out, lse
    _launch(q, k_cache, v_cache, n - 1, out, lse)
    return out, lse
