"""Calibrated testbed + benchmark suite for the paper's experiments.

Testbed (paper §IV): AMD A10-7850K (CPU, 4 CUs @ 3.1 GHz; iGPU R7 512c
@ 720 MHz) + GTX 950 (768c @ 1.24 GHz).  Problem sizes give ~2 s on the
fastest device (GPU) — the paper's "pessimistic", time-constrained regime.

The relative computing powers and overheads below are calibrated per
benchmark so the simulator reproduces the paper's qualitative and
quantitative structure: HGuided best overall (eff ~0.84 optimized), Static
good on regular programs, Dynamic sensitive to packet count (512-chunk
overhead pathology on NBody, too-large-chunk imbalance on Binomial/Ray2/
Mandelbrot), iGPU zero-copy benefit for the buffers optimization.

Each benchmark also carries its irregularity profile: the per-work-group
cost across the normalized work range (Ray scenes: cost concentrated where
spheres are; Mandelbrot: interior pixels run the full 5000 iterations).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.simulate import SimDevice

GPU_TIME_S = 2.0          # paper: ~2 s on the fastest device


@dataclass(frozen=True)
class BenchSpec:
    name: str
    total_work: int                    # work-groups
    lws: int                           # paper Table I local work size
    # relative computing powers (CPU, iGPU, GPU); GPU = 1
    rel_power: Tuple[float, float, float] = (0.15, 0.45, 1.0)
    # per-packet launch overhead per device (s): host-managed queues
    launch_overhead: Tuple[float, float, float] = (2e-4, 4e-4, 3e-4)
    # transfer seconds per work-group (in+out), paid by discrete devices;
    # the iGPU shares main memory -> zero-copy when opt_buffers
    transfer: Tuple[float, float, float] = (0.0, 1e-5, 2e-5)
    irregularity: Optional[Callable[[float], float]] = None
    regular: bool = True


def _mandel_irr(x: float) -> float:
    # interior band of the set (middle of the image) costs the full budget
    return 0.15 + 2.4 * math.exp(-((x - 0.5) ** 2) / (2 * 0.15 ** 2))


def _ray1_irr(x: float) -> float:
    # scene 1: spheres spread across the frame, mild center weighting
    return 0.45 + 1.6 * math.exp(-((x - 0.55) ** 2) / (2 * 0.22 ** 2))


def _ray2_irr(x: float) -> float:
    # scene 2: tight cluster -> strong hot band
    return 0.25 + 2.8 * math.exp(-((x - 0.45) ** 2) / (2 * 0.10 ** 2))


BENCHES: Dict[str, BenchSpec] = {
    # Gaussian 8192px, lws 128 -> one work-group = one 128-row block
    "gaussian": BenchSpec("gaussian", total_work=4096, lws=8,
                          rel_power=(0.22, 0.48, 1.0),
                          launch_overhead=(2.5e-3, 1.8e-3, 1.5e-3),
                          transfer=(0.0, 3.2e-4, 3.0e-4)),
    "binomial": BenchSpec("binomial", total_work=32768, lws=16,
                          rel_power=(0.08, 0.35, 1.0),
                          launch_overhead=(2.0e-3, 1.4e-3, 1.1e-3),
                          transfer=(0.0, 3.2e-5, 2.8e-5)),
    "nbody": BenchSpec("nbody", total_work=3584, lws=8,
                       rel_power=(0.06, 0.50, 1.0),
                       launch_overhead=(6e-3, 4.5e-3, 4e-3),
                       transfer=(0.0, 4.8e-4, 4.4e-4)),
    "ray1": BenchSpec("ray1", total_work=8192, lws=8,
                      rel_power=(0.13, 0.32, 1.0),
                      launch_overhead=(2.5e-3, 1.9e-3, 1.6e-3),
                      transfer=(0.0, 1.2e-4, 1.2e-4),
                      irregularity=_ray1_irr, regular=False),
    "ray2": BenchSpec("ray2", total_work=8192, lws=8,
                      rel_power=(0.12, 0.30, 1.0),
                      launch_overhead=(2.5e-3, 1.9e-3, 1.6e-3),
                      transfer=(0.0, 1.2e-4, 1.2e-4),
                      irregularity=_ray2_irr, regular=False),
    "mandelbrot": BenchSpec("mandelbrot", total_work=14336, lws=8,
                            rel_power=(0.16, 0.42, 1.0),
                            launch_overhead=(2.3e-3, 1.7e-3, 1.4e-3),
                            transfer=(0.0, 6e-5, 6e-5),
                            irregularity=_mandel_irr, regular=False),
}

DEVICE_NAMES = ("cpu", "igpu", "gpu")

# offline-profiling bias per device: what the scheduler's static profile
# believes relative to the truth for the actual problem (the CPU benchmarks
# optimistically under co-execution contention: runtime+scheduler threads
# steal its cores; the iGPU shares memory bandwidth with the CPU)
PROFILE_BIAS = (1.18, 0.88, 0.97)
# per-device execution jitter: the CPU co-runs the Runtime/Scheduler host
# threads (heavy contention), the iGPU shares memory bandwidth, the GPU is
# comparatively steady
JITTER = (0.26, 0.15, 0.08)


def sim_devices(bench: BenchSpec) -> List[SimDevice]:
    """The paper's 3-device testbed, calibrated so the GPU solves the whole
    problem in ~GPU_TIME_S (including its irregularity profile)."""
    irr_mean = 1.0
    if bench.irregularity is not None:
        steps = 256
        irr_mean = sum(bench.irregularity((i + 0.5) / steps)
                       for i in range(steps)) / steps
    gpu_thr = bench.total_work * irr_mean / GPU_TIME_S
    devs = []
    for i, name in enumerate(DEVICE_NAMES):
        devs.append(SimDevice(
            name=name,
            throughput=gpu_thr * bench.rel_power[i],
            launch_overhead=bench.launch_overhead[i],
            transfer_in=bench.transfer[i] * 0.5,
            transfer_out=bench.transfer[i] * 0.5,
            irregularity=bench.irregularity,
            zero_copy=(name in ("cpu", "igpu")),   # shared main memory
            profile_bias=PROFILE_BIAS[i],
            jitter=JITTER[i],
        ))
    return devs


# The paper's seven scheduling configurations of Fig. 3/4, plus the
# repo's new load-balancing algorithm (lease-amortized dispatch with a
# work-stealing tail).
SCHED_CONFIGS: List[Tuple[str, str, Dict]] = [
    ("Static", "static", {}),
    ("Static rev", "static_rev", {}),
    ("Dyn 64", "dynamic", {"n_packets": 64}),
    ("Dyn 128", "dynamic", {"n_packets": 128}),
    ("Dyn 512", "dynamic", {"n_packets": 512}),
    ("HGuided", "hguided", {}),
    ("HGuided opt", "hguided_opt", {}),
    ("HGuided steal", "hguided_steal", {}),
]


def dispatch_for(sched: str) -> str:
    """The hand-off mode a scheduler is evaluated under: hguided_steal's
    contract IS leased dispatch (lease + steal refills); everything else
    keeps the calibrated per-packet hand-off the paper measured."""
    return "leased" if sched == "hguided_steal" else "per_packet"
