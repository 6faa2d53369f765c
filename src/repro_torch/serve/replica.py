"""Model replica: one decode executor behind the serving dispatch engine.

A Replica is the serving analogue of the Engine's DeviceGroup: it owns
one model instance on one device (``cuda`` unless the caller asks for
``cpu``) and executes request packets — batched prefill + greedy decode.
Heterogeneity across replicas (mixed accelerator generations, degraded
hosts) is emulated with ``throttle`` exactly as in core/device.py;
replicas on one card share its weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.models import transformer as T


def check_servable(cfg) -> None:
    """Replicas serve (B, P) prompts of one token a position.  A model whose
    positions hold several codebooks (``encodec_stub``) takes (B, S, CB)
    tokens, so it is refused here with ``ValueError``: run it through
    ``transformer.prefill`` and ``transformer.decode_step``."""
    if cfg.frontend == "encodec_stub":
        raise ValueError(
            f"{cfg.name}: replicas serve (B, P) prompts; its positions hold "
            f"{cfg.n_codebooks} codebooks, so (B, P, CB) prompts are not "
            f"served: call transformer.prefill/decode_step")


class Replica:
    """One model replica with its own decode loop."""

    def __init__(self, name: str, cfg, params, throttle: float = 1.0,
                 device="cuda"):
        check_servable(cfg)
        self.name = name
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = params.to(self.device)     # no copy when already there
        self.group = DeviceGroup(name, device=self.device, throttle=throttle)

    def serve(self, prompts, gen: int,
              cache_len: int = None) -> np.ndarray:
        """prompts: (B, P) -> generated tokens (B, gen).

        ``cache_len`` pins the KV-cache length independently of ``gen`` so
        degraded (shorter) generations keep the shapes of full ones.  The
        tokens stay on the device until the loop ends (one copy to the
        host).  Inference mode is thread-local, so it is entered here: the
        server calls ``serve`` from its session's worker threads.
        """
        cfg = self.cfg
        B, P = prompts.shape
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(prompts), device=self.device)
            cache = T.init_cache(cfg, B, cache_len or P + gen, self.device)
            lg, cache = T.prefill(cfg, self.params, toks, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            out = []
            for i in range(gen):
                out.append(tok)
                lg, cache = T.decode_step(cfg, self.params, tok, cache,
                                          P + i)
                tok = lg[:, -1].argmax(-1, keepdim=True)
            return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
