"""Micro-benchmarks feeding the calibration: measure, don't guess.

Three raw quantities drive every constant the autotuner sets:

* **compute rate** per (kernel, device) — a small lws-aligned row-span
  sweep through the device's real compiled executable; the size sweep
  lets :mod:`repro_torch.tune.calibrate` split fixed per-run overhead from the
  per-row slope;
* **lock-crossing / thread-wake cost** — contended condition-variable
  and event ping-pongs between two threads (what one scheduler hand-off
  or one async-commit wakeup costs on this host);
* **host copy cost** vs size — the transfer-crossover economics.

All timing goes through the interleaved-median protocol
(:func:`repro_torch.tune.timing.interleaved_medians`): a shared host
drifts over a benchmark's lifetime, so candidate configurations are
interleaved with alternating visit order and scored by medians, never
timed in blocks.  A card's runs are timed through
``DeviceGroup.run_packet``, which synchronises the card before it reads
the clock.

Everything here returns *raw medians*; fitting lives in calibrate.py.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.core.runtime import Program
from repro_torch.tune.timing import interleaved_medians

DEFAULT_ROUNDS = 7
DEFAULT_COPY_SIZES = (4 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20)


@dataclass
class Measurements:
    """Raw interleaved-median samples, pre-fit.

    ``kernels[kernel][device][rows]`` is the median seconds for one
    ``rows``-row run on that device; ``copy_s[nbytes]`` the median
    seconds for one host copy of that size.  ``n_timed_runs`` counts
    every timed micro-run executed — the calibration-cache acceptance
    check asserts this stays ZERO on a warm second tune.
    """
    kernels: Dict[str, Dict[str, Dict[int, float]]] = field(
        default_factory=dict)
    crossing_s: float = 0.0
    wake_s: float = 0.0
    copy_s: Dict[int, float] = field(default_factory=dict)
    n_timed_runs: int = 0


# -- compute rate per (kernel, device) -------------------------------------

def _range_call(prog: Program, fn):
    """Adapt a compiled executable to ``call(offset, rows)`` over the
    program's full width (the microbench sweeps dim-0 panels only,
    matching the schedulers' row-panel carving)."""
    region = prog.work_region
    if region.ndim == 2:
        d0, d1 = region.dims

        def call(offset, rows):
            return fn(d0.offset + offset, rows, d1.offset, d1.size)
    else:
        d0 = region.dims[0]

        def call(offset, rows):
            return fn(d0.offset + offset, rows)
    return call


def span_grid(prog: Program, n_spans: int = 3) -> List[int]:
    """lws-aligned row spans [G/2^(n-1), ..., G/2, G] for the slope fit."""
    g, lws = prog.total_work, prog.lws
    spans = []
    for i in range(n_spans - 1, -1, -1):
        rows = max(lws, (g >> i) // lws * lws)
        if rows not in spans:
            spans.append(rows)
    return spans


def measure_compute(prog: Program, device: DeviceGroup, *,
                    spans: Optional[Sequence[int]] = None,
                    rounds: int = DEFAULT_ROUNDS):
    """``({rows: median_seconds}, n_timed_runs)`` for ``prog`` on
    ``device``.

    Runs the device's real compiled executable through
    ``DeviceGroup.run_packet`` so throttle (the emulated relative speed)
    is part of the measurement, exactly as the engine sees it.  The span
    labels themselves are the interleaved configurations — a drift burst
    biases every span equally instead of poisoning the slope.
    """
    call = _range_call(prog, prog.build(device))
    spans = list(spans) if spans is not None else span_grid(prog)
    call(0, spans[0])                       # warm-up: build outside timing
    if device.is_cuda:
        torch.cuda.synchronize(device.device)
    counter = {"runs": 0}

    def run(rows):
        device.run_packet(call, 0, rows)
        counter["runs"] += 1

    med = interleaved_medians(spans, run, rounds)
    return dict(med), counter["runs"]


# -- host cost primitives --------------------------------------------------

def _pingpong_condition(crossings: int) -> None:
    """``crossings`` contended lock hand-offs between two threads."""
    cond = threading.Condition()
    state = {"turn": 0, "left": crossings}

    def peer():
        with cond:
            while state["left"] > 0:
                cond.wait_for(lambda: state["turn"] == 1
                              or state["left"] <= 0)
                if state["left"] <= 0:
                    break
                state["turn"] = 0
                state["left"] -= 1
                cond.notify_all()

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    with cond:
        while state["left"] > 0:
            cond.wait_for(lambda: state["turn"] == 0 or state["left"] <= 0)
            if state["left"] <= 0:
                break
            state["turn"] = 1
            state["left"] -= 1
            cond.notify_all()
    t.join()


def _pingpong_events(crossings: int) -> None:
    """``crossings`` thread wakes via paired events (the committer
    hand-off shape: one Event.set -> one Event.wait wake)."""
    a, b = threading.Event(), threading.Event()
    n = crossings // 2

    def peer():
        for _ in range(n):
            a.wait()
            a.clear()
            b.set()

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    for _ in range(n):
        a.set()
        b.wait()
        b.clear()
    t.join()


def measure_host_costs(*, rounds: int = DEFAULT_ROUNDS,
                       crossings: int = 400,
                       copy_sizes: Sequence[int] = DEFAULT_COPY_SIZES):
    """One interleaved pass over every host-side primitive.

    Labels are (kind, size) pairs: the lock-crossing ping-pong, the
    event-wake ping-pong, and one copy benchmark per size all rotate
    through the same rounds, so host drift hits them evenly — the
    crossover fit compares copy cost *against* wake cost, which only
    works if both saw the same machine.

    Returns ``(crossing_s, wake_s, copy_s: {nbytes: s}, n_timed_runs)``.
    """
    bufs = {nb: (np.empty(nb, np.uint8), np.empty(nb, np.uint8))
            for nb in copy_sizes}
    copies_per_run = 8
    labels = [("crossing", 0), ("wake", 0)] + \
             [("copy", nb) for nb in copy_sizes]
    counter = {"runs": 0}

    def run(label):
        kind, nb = label
        counter["runs"] += 1
        if kind == "crossing":
            _pingpong_condition(crossings)
        elif kind == "wake":
            _pingpong_events(crossings)
        else:
            dst, src = bufs[nb]
            for _ in range(copies_per_run):
                np.copyto(dst, src)

    med = interleaved_medians(labels, run, rounds)
    crossing_s = med[("crossing", 0)] / crossings
    wake_s = med[("wake", 0)] / (crossings // 2 * 2)
    copy_s = {nb: med[("copy", nb)] / copies_per_run for nb in copy_sizes}
    return crossing_s, wake_s, copy_s, counter["runs"]


# -- the full measurement pass ---------------------------------------------

def measure(devices: Sequence[DeviceGroup],
            programs: Dict[str, Program], *,
            rounds: int = DEFAULT_ROUNDS,
            spans: Optional[Sequence[int]] = None,
            copy_sizes: Sequence[int] = DEFAULT_COPY_SIZES) -> Measurements:
    """Everything calibrate.py needs, for one fleet and a kernel set."""
    m = Measurements()
    m.crossing_s, m.wake_s, m.copy_s, n = measure_host_costs(
        rounds=rounds, copy_sizes=copy_sizes)
    m.n_timed_runs += n
    for kernel, prog in programs.items():
        per_dev = m.kernels.setdefault(kernel, {})
        for dev in devices:
            per_dev[dev.name], n = measure_compute(
                prog, dev, spans=spans, rounds=rounds)
            m.n_timed_runs += n
    return m
