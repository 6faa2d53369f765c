"""Synthetic-corpus data pipeline.

Deterministic, seekable and *packet-sliceable*: ``batch_at(step)`` is a pure
function of (seed, step), so (a) restart-from-checkpoint replays the exact
stream with no state to save, (b) the co-execution runtime can hand disjoint
row ranges of one global batch to different device groups
(``slice_rows``) without materializing the whole batch on any host, and
(c) every host in a multi-controller deployment computes its own shard
locally.  A background prefetch thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 1234
    # markov-chain synthetic text: next token depends on current (keeps the
    # loss learnable so the end-to-end example shows real convergence)
    markov_alpha: float = 0.7


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data = data
        self.V = cfg.vocab_size
        # fixed random transition structure: tok -> preferred successor
        rng = np.random.default_rng(data.seed)
        self._succ = rng.integers(0, self.V, size=(self.V,), dtype=np.int64)

    # -- pure batch construction ------------------------------------------
    def batch_at(self, step: int,
                 rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        B, S = self.shape.global_batch, self.shape.seq_len
        r0, r1 = (rows.start or 0, rows.stop if rows and rows.stop else B) \
            if rows else (0, B)
        n = r1 - r0
        ss = np.random.SeedSequence([self.data.seed, step, r0, r1])
        rng = np.random.default_rng(ss)
        cb = self.cfg.n_codebooks if self.cfg.frontend == "encodec_stub" else 0
        shape = (n, S, cb) if cb else (n, S)
        noise = rng.integers(0, self.V, size=shape, dtype=np.int64)
        toks = np.empty(shape, dtype=np.int32)
        toks[:, 0] = noise[:, 0]
        a = self.data.markov_alpha
        follow = rng.random((n, S)) < a
        for t in range(1, S):
            prev = toks[:, t - 1]
            succ = self._succ[prev]
            toks[:, t] = np.where(
                follow[:, t][..., None] if cb else follow[:, t],
                succ, noise[:, t])
        out = {"tokens": toks}
        if self.cfg.frontend == "vit_stub":
            out["patches"] = rng.standard_normal(
                (n, self.cfg.n_patches, self.cfg.d_model)).astype(np.float32)
        return out

    def slice_rows(self, step: int, start: int,
                   size: int) -> Dict[str, np.ndarray]:
        """Co-execution packet: rows [start, start+size) of global batch."""
        return self.batch_at(step, rows=slice(start, start + size))

    # -- prefetching iterator ---------------------------------------------
    def iterator(self, start_step: int = 0, depth: int = 2) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
