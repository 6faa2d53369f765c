"""Flash-decode op: the model stack's single-token cached attention
(``models/layers.py::cached_decode_attention``), which launches the CUDA
kernel on a card and takes the plain version on the host."""
from __future__ import annotations

from repro_torch.kernels.flash_decode import ref as R
from repro_torch.models.layers import cached_decode_attention


def decode_attention(q, k_cache, v_cache, pos: int):
    """q: (B,H,D); caches: (B,S,KH,D); pos: int -> (B,H,D)."""
    return cached_decode_attention(q[:, None], k_cache, v_cache, pos)[:, 0]


decode_attention_ref = R.decode_attention
