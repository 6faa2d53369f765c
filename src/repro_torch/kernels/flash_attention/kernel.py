"""Wrapper of the hand-written CUDA causal flash-attention kernel
(``csrc/flash_attention.cu``: work items of (batch, kv head, query tile)
holding the tile's rows of all G query heads, online softmax in float32
registers; bfloat16 on ``wgmma`` in persistent CTAs fed by TMA rings,
with the softmax overlapped with the products, float32 on FMAs), which
replaces the JAX package's Pallas kernel
``kernels/flash_attention/kernel.py`` ``flash_attention``.

``launches`` counts the kernel's launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as R

launches = 0

MAX_HEAD_DIM = 128
BF16_HEAD_DIMS = (64, 80, 128)  # the wgmma kernel's; every dense config
MAX_GROUP = 64          # query heads per kv head: one CTA holds >= 1 position


def flash_attention(q, k, v):
    """Causal GQA attention.  q: (B,S,H,D); k,v: (B,S,KH,D), float32
    (D <= 128) or bfloat16 (D of 64, 80 or 128), any S -> (B,S,H,D) in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    global launches
    if q.device.type == "cpu":
        return R.attention_ref(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: expected float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(f"flash_attention {name}", t, q.dtype, 4)
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on another device")
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if (KH == 0 or H % KH or H // KH > MAX_GROUP or not 0 < D <= MAX_HEAD_DIM
            or (q.dtype == torch.bfloat16 and D not in BF16_HEAD_DIMS)):
        raise ValueError(f"flash_attention: H={H}, KH={KH}, D={D}, "
                         f"{q.dtype} not supported (H % KH == 0, H/KH <= "
                         f"{MAX_GROUP}, D <= {MAX_HEAD_DIM}; bfloat16: D in "
                         f"{BF16_HEAD_DIMS})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if B and S:
        build.launch("flash_attention_fwd", q, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), B, S, H, KH, D,
                     int(q.dtype == torch.bfloat16))
        launches += 1
    return out
