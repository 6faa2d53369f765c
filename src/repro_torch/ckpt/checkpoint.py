"""The co-execution run journal (:class:`RunJournal` / :func:`resume_run`):
the persistent run state behind DAG checkpoint/resume.

Every packet a run commits appends one length-framed record — node key,
absolute dim-0 span, and the committed output rows (host numpy, as the
runtime's commit hands them over) — exactly when the scheduler's
lease/exact-cover bookkeeping releases the packet, so the journal's
spans tile each node's region without overlap.  A killed session resumes
from the journal: committed spans are replayed into the output buffer
(zero re-execution) and only the uncovered **gaps** are re-submitted as
lws-aligned sub-region runs.  A torn tail record (the process died
mid-append) is detected by the framing and dropped, so a crash can lose
at most the packet being written — never corrupt the committed prefix.

The on-disk format is the JAX package's byte for byte (magic, ``<I``
header length, JSON header, payload), so a journal written by either
package reads the same in the other.  Framework-free: numpy only.  The
JAX package's other half of this module, sharded model-state
checkpoints, comes with the training slice of the port.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

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
