"""Wrapper of the hand-written CUDA flash-decode kernel
(``csrc/flash_decode.cu``: the live keys [0, pos] cut into splits, one
CTA per (split, kv head, batch) reading whole cache rows with 16-byte
loads, then a combine pass), which replaces the JAX package's Pallas
kernel ``kernels/flash_decode/kernel.py`` ``flash_decode``.

``launches`` counts the wrapper's launches (one split pass and its
combine pass each) and nothing else."""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref as R

launches = 0

SPLIT_KEYS = 64         # a split is a whole number of 64-key blocks
MAX_GROUP = 8           # query heads per kv head


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits(batch: int, kv_heads: int, pos: int, sm_count: int):
    """(n_splits, keys_per_split) for keys [0, pos]: enough CTAs for two
    per SM, each split a whole number of SPLIT_KEYS blocks, none empty."""
    n_blocks = -(-(pos + 1) // SPLIT_KEYS)
    want = -(-2 * sm_count // max(batch * kv_heads, 1))
    per_split = -(-n_blocks // max(1, min(n_blocks, want)))
    return -(-n_blocks // per_split), per_split * SPLIT_KEYS


def flash_decode(q, k_cache, v_cache, pos):
    """q: (B,H,D); caches: (B,Smax,KH,D) in their storage dtype (float32
    or bfloat16); ``pos`` a Python int -> (B,H,D) in q's dtype, attending
    to cache positions [0, pos].  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which reads only the live keys."""
    global launches
    pos = operator.index(pos)
    if q.device.type == "cpu":
        return R.decode_attention(q, k_cache, v_cache, pos)
    cdt = k_cache.dtype
    if cdt not in (torch.float32, torch.bfloat16) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: q {q.dtype}, cache {cdt} (float32 "
                        f"or bfloat16)")
    build.check_cuda("flash_decode k_cache", k_cache, cdt, 4)
    build.check_cuda("flash_decode v_cache", v_cache, cdt, 4)
    build.check_cuda("flash_decode q", q, q.dtype, 3)
    B, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, Smax, KH, D) or v_cache.shape != k_cache.shape
            or q.device != k_cache.device or v_cache.device != q.device):
        raise ValueError(f"flash_decode: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    vec = 16 // k_cache.element_size()
    if (KH == 0 or H % KH or H // KH > MAX_GROUP or D > 128 or D % vec
            or not 0 <= pos < Smax):
        raise ValueError(f"flash_decode: H={H}, KH={KH}, D={D}, pos={pos}, "
                         f"Smax={Smax} not supported")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: caches must be 16-byte aligned")
    # cached_decode_attention casts q to the cache's type
    qc = q.to(cdt).contiguous()
    ns, kps = splits(B, KH, pos, _sm_count(q.device))
    G = H // KH
    part_o = torch.empty((B, KH, ns, G, D), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B, KH, ns, G, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    build.launch("flash_decode_fwd", q, qc.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), out.data_ptr(), part_o.data_ptr(),
                 part_ml.data_ptr(), B, Smax, H, KH, D, pos, ns, kps,
                 int(cdt == torch.bfloat16), int(q.dtype == torch.bfloat16))
    launches += 1
    return out
