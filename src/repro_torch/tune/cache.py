"""Persistent autotuning cache: calibrations + winners per device fleet.

Modeled on XLA's autotuning cache: results are keyed by a *device
fingerprint* (what the fleet looks like), stored as versioned JSON, and
every read path is defensive — a corrupt, torn, or stale file silently
degrades to "no cache" and the next store rewrites it atomically.

Layout on disk::

    {"version": 1,
     "entries": {
        "<fingerprint>": {
            "calibration": {...},              # fitted cost terms
            "winners": {"<kernel>": {...}}     # TunedConfig per kernel
        }}}

Nothing in here runs a micro-benchmark; see
:mod:`repro_torch.tune.microbench` (measure),
:mod:`repro_torch.tune.calibrate` (fit) and :mod:`repro_torch.tune.search`
(sweep + confirm) for how entries are produced.

The default file is the port's own (``~/.cache/repro_torch/``), so a
calibration that the JAX package measured is never read here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional

CACHE_VERSION = 1

DEFAULT_CACHE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "tune_cache.json")


# -- fingerprint -----------------------------------------------------------

def _card_name(device) -> str:
    """The product name of a CUDA device, '' for anything else."""
    if getattr(device, "type", None) != "cuda":
        return ""
    import torch
    return torch.cuda.get_device_name(device)


def device_fingerprint(devices) -> str:
    """Stable identity of a device fleet for cache keying.

    Covers what the calibration actually depends on: each device's name,
    throttle, power model and executor (``cpu``, ``cuda:0``; for a card
    also its product name, so two cards of different kinds never share a
    calibration), plus the host's core count (lock-crossing and wake
    costs are an oversubscription story).  Order-insensitive — the same
    fleet listed in a different order is the same fingerprint.
    """
    parts = []
    for d in devices:
        device = getattr(d, "device", None)
        parts.append([
            str(getattr(d, "name", d)),
            float(getattr(d, "throttle", 1.0)),
            repr(getattr(d, "power_model", None)),
            str(device),
            _card_name(device),
        ])
    blob = json.dumps({"devices": sorted(parts),
                       "cpus": os.cpu_count(),
                       "version": CACHE_VERSION}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# -- calibration (the fitted cost terms) -----------------------------------

@dataclass
class DeviceCalibration:
    """One device's fitted terms for one kernel: ``t(rows) =
    overhead_s + rows / throughput`` (slope/intercept of the
    interleaved-median size sweep)."""
    throughput: float                    # work-groups (rows) / second
    overhead_s: float = 0.0              # per-run fixed cost (launch+sync)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DeviceCalibration":
        return cls(throughput=float(d["throughput"]),
                   overhead_s=float(d.get("overhead_s", 0.0)))


@dataclass
class Calibration:
    """Fitted simulator cost terms for one device fleet.

    ``kernels[kernel][device_name]`` holds the per-(kernel, device)
    compute fit; the host-side terms (lock crossing, thread wake, copy
    bandwidth) are kernel-independent.
    """
    kernels: Dict[str, Dict[str, DeviceCalibration]] = field(
        default_factory=dict)
    sched_overhead_s: float = 2e-4       # one contended lock crossing
    wake_cost_s: float = 2e-4            # one thread hand-off wake
    transfer_base_s: float = 0.0         # fixed cost of one host copy
    transfer_s_per_byte: float = 0.0     # copy slope (1 / bandwidth)

    def to_dict(self) -> Dict:
        return {
            "kernels": {k: {d: c.to_dict() for d, c in devs.items()}
                        for k, devs in self.kernels.items()},
            "sched_overhead_s": self.sched_overhead_s,
            "wake_cost_s": self.wake_cost_s,
            "transfer_base_s": self.transfer_base_s,
            "transfer_s_per_byte": self.transfer_s_per_byte,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Calibration":
        return cls(
            kernels={k: {dn: DeviceCalibration.from_dict(c)
                         for dn, c in devs.items()}
                     for k, devs in d.get("kernels", {}).items()},
            sched_overhead_s=float(d["sched_overhead_s"]),
            wake_cost_s=float(d.get("wake_cost_s", 2e-4)),
            transfer_base_s=float(d.get("transfer_base_s", 0.0)),
            transfer_s_per_byte=float(d.get("transfer_s_per_byte", 0.0)),
        )


# -- the tuned result ------------------------------------------------------

@dataclass
class TunedConfig:
    """The autotuner's output: every constant the session can apply.

    ``None`` fields mean "keep the hand-picked default" — a TunedConfig
    is a sparse overlay, so partial tunes compose with explicit session
    kwargs (which always win; see ``EngineSession(tuned=...)``).
    """
    kernel: Optional[str] = None             # provenance
    fingerprint: Optional[str] = None        # fleet it was tuned for
    scheduler: Optional[str] = None
    scheduler_kwargs: Optional[Dict] = None  # e.g. {"n_packets": 16}
    lws: Optional[int] = None                # dim-0 panel alignment
    lease_overhead_s: Optional[float] = None
    lease_overhead_frac: Optional[float] = None
    lease_k_max: Optional[int] = None
    async_threshold_bytes: Optional[int] = None
    predicted_s: Optional[float] = None      # simulator's winning time
    predicted_default_s: Optional[float] = None  # simulator's default time
    confirmed_s: Optional[float] = None      # hardware-confirmed median

    def lease_params(self) -> Dict:
        """Non-None lease constants, in ``set_lease_params`` form."""
        return {k: v for k, v in (
            ("lease_overhead_s", self.lease_overhead_s),
            ("lease_overhead_frac", self.lease_overhead_frac),
            ("lease_k_max", self.lease_k_max)) if v is not None}

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "TunedConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# -- the cache file --------------------------------------------------------

class TuneCache:
    """Versioned on-disk store of calibrations and per-kernel winners.

    Every ``put_*`` persists immediately via an atomic temp-file +
    ``os.replace`` write, so a concurrent reader sees either the old or
    the new file, never a torn one.  Loads tolerate missing, corrupt,
    and wrong-version files by starting empty.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else DEFAULT_CACHE_PATH
        self._data = self._load()

    # -- read paths (all defensive) ----------------------------------------
    def _empty(self) -> Dict:
        return {"version": CACHE_VERSION, "entries": {}}

    def _load(self) -> Dict:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return self._empty()
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION \
                or not isinstance(raw.get("entries"), dict):
            return self._empty()     # stale schema: recalibrate
        return raw

    def get_calibration(self, fingerprint: str) -> Optional[Calibration]:
        ent = self._data["entries"].get(fingerprint, {})
        try:
            return Calibration.from_dict(ent["calibration"])
        except (KeyError, TypeError, ValueError, AttributeError):
            return None

    def get_winner(self, fingerprint: str,
                   kernel: str) -> Optional[TunedConfig]:
        ent = self._data["entries"].get(fingerprint, {})
        try:
            return TunedConfig.from_dict(ent["winners"][kernel])
        except (KeyError, TypeError, ValueError, AttributeError):
            return None

    def winners(self, fingerprint: str) -> Dict[str, TunedConfig]:
        ent = self._data["entries"].get(fingerprint, {})
        out = {}
        for kernel, d in (ent.get("winners") or {}).items():
            try:
                out[kernel] = TunedConfig.from_dict(d)
            except (TypeError, ValueError, AttributeError):
                continue
        return out

    # -- write paths -------------------------------------------------------
    def put_calibration(self, fingerprint: str, cal: Calibration) -> None:
        ent = self._data["entries"].setdefault(fingerprint, {})
        ent["calibration"] = cal.to_dict()
        self.save()

    def put_winner(self, fingerprint: str, kernel: str,
                   cfg: TunedConfig) -> None:
        ent = self._data["entries"].setdefault(fingerprint, {})
        ent.setdefault("winners", {})[kernel] = cfg.to_dict()
        self.save()

    def save(self) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune_cache.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


# -- session entry point ---------------------------------------------------

def resolve_tuned(tuned, *, devices=None,
                  kernel: Optional[str] = None) -> Optional[TunedConfig]:
    """Turn the session's ``tuned=`` argument into a TunedConfig.

    Accepts a :class:`TunedConfig` (returned as-is), a plain dict, a path
    to a TunedConfig JSON file, a :class:`TuneCache`, or ``True`` (open
    the default cache).  Cache forms look up the fleet's fingerprint:
    the winner for ``kernel`` when given, else the sole stored winner,
    else ``None`` — a miss quietly keeps the hand-picked defaults, so
    ``tuned=True`` is always safe to pass.
    """
    if tuned is None or tuned is False:
        return None
    if isinstance(tuned, TunedConfig):
        return tuned
    if isinstance(tuned, dict):
        return TunedConfig.from_dict(tuned)
    cache: Optional[TuneCache] = None
    if isinstance(tuned, TuneCache):
        cache = tuned
    elif tuned is True:
        cache = TuneCache()
    elif isinstance(tuned, (str, os.PathLike)):
        path = os.fspath(tuned)
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return None
        if isinstance(raw, dict) and "entries" in raw:
            cache = TuneCache(path)       # a whole cache file
        elif isinstance(raw, dict):
            return TunedConfig.from_dict(raw)
        else:
            return None
    else:
        raise TypeError(f"tuned= accepts TunedConfig, dict, path, "
                        f"TuneCache, or True — got {type(tuned).__name__}")
    if devices is None:
        return None
    fp = device_fingerprint(devices)
    if kernel is not None:
        return cache.get_winner(fp, kernel)
    winners = cache.winners(fp)
    if len(winners) == 1:
        return next(iter(winners.values()))
    return winners.get("default")
