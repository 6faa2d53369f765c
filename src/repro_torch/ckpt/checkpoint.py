"""Fault-tolerant checkpointing + the co-execution run journal, the JAX
package's ``ckpt/checkpoint.py`` on PyTorch.

Two persistence layers live here:

1. **Training checkpoints** (``save``/``restore``/``AsyncCheckpointer``):
   Layout:  <dir>/step_<n>/
               manifest.json     step, host count, each leaf's shape and dtype
               host<k>.pt        ``torch.save`` of a flat dict from leaf name
                                 ("step", "params/<name>", "mu/<name>",
                                 "nu/<name>") to a CPU tensor
               COMMIT            written last — a checkpoint without COMMIT
                                 is incomplete and ignored on restore
   Writes go to ``step_<n>.tmp`` and are atomically renamed, so a failure
   mid-save never corrupts the latest good checkpoint.
   ``AsyncCheckpointer`` snapshots to host memory synchronously
   (``.detach().to("cpu", copy=True)``) and persists on a background
   thread, so the train loop only blocks for the copy, not the I/O.  One
   process writes ``host0``.

2. **The run journal** (:class:`RunJournal` / :func:`resume_run`): the
   persistent run state behind DAG checkpoint/resume.  Every packet a run
   commits appends one length-framed record — node key, absolute dim-0
   span, and the committed output rows (host numpy, as the runtime's
   commit hands them over) — exactly when the scheduler's lease/exact-cover
   bookkeeping releases the packet, so the journal's spans tile each
   node's region without overlap.  A killed session resumes from the
   journal: committed spans are replayed into the output buffer (zero
   re-execution) and only the uncovered **gaps** are re-submitted as
   lws-aligned sub-region runs.  A torn tail record (the process died
   mid-append) is detected by the framing and dropped, so a crash can lose
   at most the packet being written — never corrupt the committed prefix.
   The on-disk format is the JAX package's byte for byte (magic, ``<I``
   header length, JSON header, payload), so a journal written by either
   package reads the same in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import TrainState


def _flatten(state: TrainState) -> Dict[str, torch.Tensor]:
    """A train state's leaves by name: "step", then "params/<name>",
    "mu/<name>", "nu/<name>" in ``named_parameters()`` order."""
    flat = {"step": state.step}
    for name, p in state.params.named_parameters():
        flat[f"params/{name}"] = p
    for tree in ("mu", "nu"):
        for name, t in getattr(state, tree).items():
            flat[f"{tree}/{name}"] = t
    return flat


def _write(flat: Dict[str, torch.Tensor], directory: str, step: int,
           host_id: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    torch.save(flat, os.path.join(tmp, f"host{host_id}.pt"))
    manifest = {
        "step": step,
        "hosts": 1,
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": str(v.dtype).removeprefix("torch.")}
                   for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _snapshot(state: TrainState) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in _flatten(state).items()}


def save(state: TrainState, directory: str, step: int, *, host_id: int = 0,
         keep: int = 3) -> str:
    """Write ``state`` as ``<directory>/step_<step>`` and keep the newest
    ``keep`` committed steps; returns the step's directory."""
    return _write(_snapshot(state), directory, step, host_id, keep)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            p = os.path.join(directory, name)
            if os.path.exists(os.path.join(p, "COMMIT")):
                out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore(template: TrainState, directory: str,
            step: Optional[int] = None, *, host_id: int = 0):
    """Fill ``template`` (a train state of the checkpoint's structure) in
    place from a committed step (the latest by default): each leaf's
    shape is checked against the manifest and its values copied onto the
    template's tensor, on that tensor's device.  Returns (state, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = torch.load(os.path.join(path, f"host{host_id}.pt"),
                      map_location="cpu")
    with torch.no_grad():
        for key, leaf in _flatten(template).items():
            arr = data[key]
            want = manifest["leaves"][key]
            if list(arr.shape) != want["shape"] or arr.shape != leaf.shape:
                raise ValueError(f"{path}: {key} has shape "
                                 f"{tuple(arr.shape)}, manifest "
                                 f"{want['shape']}, template "
                                 f"{tuple(leaf.shape)}")
            leaf.copy_(arr)
    return template, step


class AsyncCheckpointer:
    """Snapshot synchronously, persist asynchronously; at most one pending."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error

    def save(self, state: TrainState, step: int):
        self.wait()
        snapshot = _snapshot(state)

        def run():
            try:
                _write(snapshot, self.directory, step, 0, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


# ---------------------------------------------------------------------------
# Run journal: persistent packet-commit state for resumable (DAG) runs.
# ---------------------------------------------------------------------------

_JOURNAL_MAGIC = b"RPJ1"


@dataclass(frozen=True)
class PacketRecord:
    """One committed packet: node key, absolute dim-0 span (work-groups,
    relative to the node program's region start) and its output rows."""
    key: str
    offset: int
    size: int
    data: np.ndarray


class RunJournal:
    """Append-only, crash-safe packet-commit journal.

    Framing per record: ``<u32 header_len><header JSON><payload bytes>``
    after a 4-byte file magic.  The header carries the payload geometry
    (shape + dtype), so a reader never trusts payload length to anything
    but the header it just validated; an incomplete tail record (torn
    write) fails the frame check and is dropped.

    Thread-safe: run contexts append from many device/committer threads.
    Appends are flushed per record — after a kill, everything written is
    recoverable up to the packet being appended at the instant of death.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = None
        self.appended = 0

    def _open_locked(self):
        if self._fh is None:
            fresh = not os.path.exists(self.path) \
                or os.path.getsize(self.path) == 0
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab")
            if fresh:
                self._fh.write(_JOURNAL_MAGIC)
        return self._fh

    def append_packet(self, key: str, offset: int, size: int,
                      payload: np.ndarray) -> None:
        """Record one committed packet (called by the engine under the
        packet's commit, before its scheduler ``release``)."""
        arr = np.ascontiguousarray(payload)
        header = json.dumps({
            "key": key, "off": int(offset), "size": int(size),
            "shape": list(arr.shape), "dtype": str(arr.dtype),
        }).encode()
        with self._lock:
            fh = self._open_locked()
            fh.write(struct.pack("<I", len(header)))
            fh.write(header)
            fh.write(arr.tobytes())
            fh.flush()
            self.appended += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading ------------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> Dict[str, List[PacketRecord]]:
        """Load every complete record, grouped by node key.  A missing
        file reads as empty (nothing was ever committed); a torn tail
        record is silently dropped (it never committed)."""
        out: Dict[str, List[PacketRecord]] = {}
        if not os.path.exists(path):
            return out
        with open(path, "rb") as fh:
            blob = fh.read()
        if blob[:4] != _JOURNAL_MAGIC:
            raise ValueError(f"{path}: not a run journal "
                             f"(magic {blob[:4]!r})")
        pos = 4
        n = len(blob)
        while pos + 4 <= n:
            (hlen,) = struct.unpack_from("<I", blob, pos)
            if pos + 4 + hlen > n:
                break                          # torn header
            try:
                hdr = json.loads(blob[pos + 4:pos + 4 + hlen])
            except ValueError:
                break                          # torn / corrupt header
            dtype = np.dtype(hdr["dtype"])
            nbytes = int(np.prod(hdr["shape"])) * dtype.itemsize
            start = pos + 4 + hlen
            if start + nbytes > n:
                break                          # torn payload
            data = np.frombuffer(blob[start:start + nbytes],
                                 dtype=dtype).reshape(hdr["shape"])
            out.setdefault(hdr["key"], []).append(
                PacketRecord(hdr["key"], hdr["off"], hdr["size"], data))
            pos = start + nbytes
        return out

    @classmethod
    def truncate_packets(cls, path: str, keep: int,
                         out_path: Optional[str] = None) -> str:
        """Copy the journal keeping only the first ``keep`` records — the
        test/benchmark stand-in for a session killed at a packet
        boundary.  Returns the truncated journal's path."""
        out_path = out_path or path + f".trunc{keep}"
        with open(path, "rb") as fh:
            blob = fh.read()
        pos = 4
        for _ in range(keep):
            (hlen,) = struct.unpack_from("<I", blob, pos)
            hdr = json.loads(blob[pos + 4:pos + 4 + hlen])
            nbytes = (int(np.prod(hdr["shape"]))
                      * np.dtype(hdr["dtype"]).itemsize)
            pos += 4 + hlen + nbytes
        with open(out_path, "wb") as fh:
            fh.write(blob[:pos])
        return out_path


def merge_spans(records) -> List[Tuple[int, int]]:
    """Merge packet spans into maximal disjoint ``[a, b)`` intervals."""
    spans = sorted((r.offset, r.offset + r.size) for r in records)
    merged: List[Tuple[int, int]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


@dataclass
class ResumeReport:
    """What :func:`resume_run` did for one node."""
    output: np.ndarray
    replayed_wg: int = 0        # work-groups restored from the journal
    executed_wg: int = 0        # work-groups re-executed via gap submits
    gaps: List[Tuple[int, int]] = field(default_factory=list)
    results: List = field(default_factory=list)   # gap RunResults

    @property
    def fully_replayed(self) -> bool:
        return self.executed_wg == 0


def resume_run(session, program, journal: RunJournal, key: str,
               **submit_kw) -> ResumeReport:
    """Resume one node of a journaled graph: replay committed packets,
    re-execute only the gaps.

    Committed spans from ``journal`` (read from disk, so a freshly
    restarted process works) are written straight into the node's output
    buffer — zero device work.  The uncovered remainder is submitted as
    lws-aligned sub-region runs (``region=``) through ``session``, with
    the same journal attached so a *second* kill resumes from strictly
    more progress.  Packet carve boundaries are always dim-0 lws-aligned
    (final remainder excepted), so every gap is a valid ROI region by
    construction.  Blocking; returns a :class:`ResumeReport`.
    """
    from repro_torch.core.region import Dim, Region   # local: avoid cycles

    region = program.work_region
    d0 = region.dims[0]
    G = d0.size
    out_cols = program.out_cols if region.ndim == 1 \
        else region.dims[1].size * program.out_cols
    rpw = program.out_rows_per_wg
    output = np.zeros((G * rpw, out_cols), program.out_dtype)

    records = RunJournal.read(journal.path).get(key, [])
    replayed = 0
    for rec in records:
        if not (0 <= rec.offset and rec.offset + rec.size <= G):
            raise ValueError(
                f"journal {journal.path}: record [{rec.offset}, "
                f"{rec.offset + rec.size}) outside node {key!r} "
                f"work range [0, {G})")
        rows = rec.data.reshape(rec.size * rpw, out_cols)
        output[rec.offset * rpw:(rec.offset + rec.size) * rpw] = rows
    committed = merge_spans(records)
    replayed = sum(b - a for a, b in committed)

    # the gaps: maximal uncovered [a, b) intervals of the node's dim-0
    gaps: List[Tuple[int, int]] = []
    cursor = 0
    for a, b in committed:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < G:
        gaps.append((cursor, G))

    report = ResumeReport(output=output, replayed_wg=replayed, gaps=gaps)
    if not gaps:
        return report

    handles = []
    for a, b in gaps:
        gap_region = Region((Dim(d0.offset + a, b - a, d0.lws),)
                            + region.dims[1:])
        handles.append(session.submit(program, region=gap_region,
                                      journal=journal, journal_key=key,
                                      **submit_kw))
    for (a, b), h in zip(gaps, handles):
        res = h.result()
        report.results.append(res)
        report.executed_wg += b - a
        output[a * rpw:b * rpw] = np.asarray(res.output).reshape(
            (b - a) * rpw, out_cols)
    return report
