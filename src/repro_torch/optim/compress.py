"""Gradient compression with error feedback: int8 quantisation, the
residual carried to the next step in bfloat16.  The JAX package's
``optim/compress.py`` with its arithmetic (``torch.round`` rounds half to
even, as ``jnp.round`` does), on dicts from parameter name to gradient:

    g_q, new_err = compress_decompress(grads, err)

The reference takes one scale per array of its parameter tree, and that
tree stacks every layer's parameters over a leading ``n_blocks`` axis.
So the port takes one scale per parameter outside the layers and one per
parameter name across all layers (``layers.<i>.mixer.wq`` for every
``i`` shares one): the same codes as the reference's on the same
gradients.  Every family the port covers repeats a period of one layer.
On a rank of a sharded model (``res``) each group's absmax is the max
over every rank of the mesh (one all-reduce of them all an axis above
1), the scale the reference takes of the whole tensors.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch

_LAYER = re.compile(r"^layers\.\d+\.")


def _scale_group(name: str) -> str:
    """The reference array a parameter belongs to: all layers' same-named
    parameters form one stacked array."""
    return _LAYER.sub("layers.*.", name)


def quantize(g32: torch.Tensor, absmax: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int8 codes in [-127, 127], float32 scale), the scale
    from ``absmax``, the largest |g| of the scale's group."""
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error(params) -> Dict[str, torch.Tensor]:
    """bfloat16 zeros for every parameter of ``params`` (an nn.Module)."""
    return {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for n, p in params.named_parameters()}


def compress_decompress(
        grads: Mapping[str, torch.Tensor],
        err: Optional[Mapping[str, torch.Tensor]], res=None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (dequantized grads, new error-feedback buffers); ``res``
    a rank's blocks (the module's docstring)."""
    g32 = {n: g.float() + (err[n].float() if err is not None else 0.0)
           for n, g in grads.items()}
    absmax: Dict[str, torch.Tensor] = {}
    for n, x in g32.items():
        k, m = _scale_group(n), torch.max(torch.abs(x))
        absmax[k] = m if k not in absmax else torch.maximum(
            absmax[k], m.to(absmax[k].device))
    if res is not None and absmax:
        both = res.max_over_mesh(torch.stack(list(absmax.values())))
        absmax = dict(zip(absmax, both))
    deq, new_err = {}, {}
    for n, x in g32.items():
        q, scale = quantize(x, absmax[_scale_group(n)].to(x.device))
        d = q.float() * scale
        deq[n] = d.to(grads[n].dtype)
        new_err[n] = (x - d).to(torch.bfloat16)
    return deq, new_err


def wire_bytes_saved_fraction() -> float:
    """int8 payload vs bf16 wire format across the pod axis."""
    return 0.5
