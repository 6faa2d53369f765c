"""The interleaved-median timing protocol of the autotuner.

Candidate configurations are interleaved with alternating visit order and
scored by medians, never timed in blocks, so host drift hits every label
evenly.  This is the port's own copy of the one-window form of the JAX
package's benchmark helper (``benchmarks/common.py``), which imports the
JAX package.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Hashable, List, Sequence


def interleaved_medians(labels: Sequence[Hashable],
                        run: Callable[[Hashable], object],
                        rounds: int) -> Dict[Hashable, float]:
    """Drift-cancelling timing protocol: ``{label: median_seconds}``.

    A shared host drifts in throughput over a benchmark's lifetime, so
    configurations must be interleaved (never timed back-to-back in blocks)
    and the visit order must alternate each round so no label systematically
    runs first on a warm (or throttled) machine.

    ``run(label)`` is invoked once per (round, label) and timed with
    ``time.perf_counter``; callers that need per-run observations (waits,
    packet counts, exactness checks) record them inside the closure.
    """
    if rounds < 1:
        raise ValueError(f"need >= 1 round, got {rounds}")
    labels = list(labels)
    times: Dict[Hashable, List[float]] = {lb: [] for lb in labels}
    for rnd in range(rounds):
        order = labels if rnd % 2 == 0 else labels[::-1]
        for lb in order:
            t0 = time.perf_counter()
            run(lb)
            times[lb].append(time.perf_counter() - t0)
    return {lb: statistics.median(ts) for lb, ts in times.items()}
