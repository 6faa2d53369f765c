"""Run one function on ``world`` ranks of ``torch.distributed``.

:func:`run` spawns ``world`` processes (the ``spawn`` start method), joins
them in one process group over a file store in a directory the caller
gives (no TCP port to agree on, so concurrent runs cannot collide), calls
``fn(rank, world, *args)`` on each, and returns their results by rank.
The backend and the device are arguments the caller must give, with
no default and nothing that picks one: ``gloo`` where ranks share
one card or run on the CPU (NCCL refuses two ranks on one GPU), ``nccl``
for one rank a card.  A rank that raises makes :func:`run` raise with its
traceback, and so does a run that outlasts ``timeout``; either way every
rank is stopped.

:func:`fake_group` starts a one-process group on the ``fake`` backend,
whose collectives return tensors of the right shapes without moving
data: the planner runs rank 0's step under it on the ``meta`` device.
"""
from __future__ import annotations

import contextlib
import faulthandler
import os
import pickle
import queue
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

BACKENDS = ("gloo", "nccl")


def _rank_main(fn, rank, world, backend, device, store_path, timeout, args,
               results):
    faulthandler.enable()       # a crash in native code prints its stack
    started = False
    try:
        dev = torch.device(device)
        if dev.type == "cuda":     # "cuda" alone: rank r on card r
            torch.cuda.set_device(rank if dev.index is None else dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        started = True
        # pickled here, by value: a tensor handed to the queue as it is
        # would be shared through a descriptor that dies with this process
        out = (rank, True, pickle.dumps(fn(rank, world, *args)))
    except BaseException:        # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    # reported before the group goes, which fails the other ranks' waits
    results.put(out)
    if started:
        dist.destroy_process_group()


def run(fn: Callable, world: int, *, store_dir: str, backend: str,
        device: str, args: Sequence[Any] = (),
        timeout: float = 120.0) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks (``fn`` and
    ``args`` are pickled: a module-level function); returns the results
    (pickled by value, tensors too), rank 0 first.  ``store_dir`` holds
    the file store; ``backend`` is one of :data:`BACKENDS` and ``device``
    each rank's (``"cpu"``; ``cuda:<i>``, which every rank sets current;
    or ``"cuda"``, card r for rank r): neither has a default."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"world {world}")
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-"
                                         f"{time.monotonic_ns()}")
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device, store_path,
                               timeout, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"gave no result within {timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} exited with "
                        f"{[procs[i].exitcode for i in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(_failures(results, rank, val, world))
            out[rank] = pickle.loads(val)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(world)]


def _failures(results, rank, text, world, grace: float = 2.0) -> str:
    """The first failure and those other ranks report within ``grace``
    seconds (a rank that dies makes its peers' collectives fail too)."""
    msgs, end = [f"rank {rank} of {world} failed:\n{text}"], (
        time.monotonic() + grace)
    while time.monotonic() < end:
        try:
            r, ok, val = results.get(timeout=max(end - time.monotonic(),
                                                 0.01))
        except queue.Empty:
            break
        if not ok:
            msgs.append(f"rank {r} of {world} failed:\n{val}")
    return "\n".join(msgs)


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake``-backend group of ``world`` ranks, this process rank 0,
    for the block; destroyed after it.  Refuses to start beside a default
    group the caller already has."""
    from torch.testing._internal.distributed import fake_pg

    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
