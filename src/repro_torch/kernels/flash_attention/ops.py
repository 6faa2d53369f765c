"""Flash-attention op: the model stack's causal attention
(``models/layers.py::blocked_causal_attention``), which launches the CUDA
kernel on a card and takes the plain version on the host."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import ref as R
from repro_torch.models.layers import blocked_causal_attention


def attention(q, k, v, *, chunk: int = 2048):
    return blocked_causal_attention(q, k, v, chunk)


attention_ref = R.attention_ref
