"""RunHandle: the future-like handle returned by ``EngineSession.submit``.

Deliberately a subset of ``concurrent.futures.Future`` (result / done /
cancel / exception) so callers can overlap input preparation with in-flight
runs — exactly as the paper's init optimization overlaps compiles — without
learning a new waiting idiom.  ``CancelledError`` is the standard library's.

A handle may also be a **predecessor** of later submits
(``EngineSession.submit(program, deps=[handle])``): the session dispatches
the dependent the moment every predecessor finishes.  Dependency outcomes
surface here too — a cancelled predecessor cascades (dependents transition
to the CANCELLED terminal state), and a failed predecessor fails its
dependents with :class:`DependencyError` on ``result()``.
"""
from __future__ import annotations

import threading
from concurrent.futures import CancelledError
from typing import Any, Callable, List, Optional

__all__ = ["CancelledError", "DependencyError", "RunHandle"]


class DependencyError(RuntimeError):
    """A run could not start because a predecessor failed.

    Raised from ``RunHandle.result()`` / stored as its ``exception()`` on
    every (transitive) dependent of a failed submit.  ``cause`` is the
    predecessor's own exception (also chained via ``__cause__``)."""

    def __init__(self, program_name: str, dep_name: str,
                 cause: Optional[BaseException] = None):
        super().__init__(
            f"run of {program_name!r} not started: predecessor "
            f"{dep_name!r} failed ({cause!r})")
        self.program_name = program_name
        self.dep_name = dep_name
        self.cause = cause

_PENDING = "pending"
_RUNNING = "running"
_DONE = "done"
_CANCELLED = "cancelled"


class RunHandle:
    """Handle for one submitted program; created only by EngineSession."""

    def __init__(self, program_name: str, seq: int,
                 discard: Optional[Callable[[], None]] = None,
                 deps: Optional[List["RunHandle"]] = None):
        self.program_name = program_name
        self.seq = seq                       # session-wide submit index
        self.deps: List["RunHandle"] = list(deps or [])  # predecessors
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._state = _PENDING
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._discard = discard              # session queue-removal hook
        self._callbacks: List[Callable[["RunHandle"], None]] = []

    # -- caller side --------------------------------------------------------
    def done(self) -> bool:
        """True once the run finished, errored, or was cancelled."""
        return self._event.is_set()

    def running(self) -> bool:
        return self._state == _RUNNING

    def cancelled(self) -> bool:
        return self._state == _CANCELLED

    def succeeded(self) -> bool:
        """True once the run finished and produced a RunResult."""
        return (self._event.is_set() and self._state == _DONE
                and self._exception is None)

    def failed(self) -> bool:
        """True once the run finished with an exception."""
        return self._event.is_set() and self._exception is not None

    def cancel(self) -> bool:
        """Cancel if still queued.  Returns False once dispatch started —
        in-flight co-execution is not interrupted (packets already carved
        must commit exactly once).  A successful cancel removes the
        submission from the session queue immediately: ``done()`` flips
        right away and the dispatcher never sees (nor pays init for) it."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
        self._event.set()
        if self._discard is not None:
            # outside self._lock: the hook takes the session queue lock and
            # the dispatcher takes these locks in the opposite order
            self._discard()
        self._run_callbacks()
        return True

    def result(self, timeout: Optional[float] = None):
        """Block until the RunResult is ready; re-raises run errors."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"run of {self.program_name!r} not done after {timeout}s")
        if self._state == _CANCELLED:
            raise CancelledError(f"run of {self.program_name!r} cancelled")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"run of {self.program_name!r} not done after {timeout}s")
        if self._state == _CANCELLED:
            raise CancelledError(f"run of {self.program_name!r} cancelled")
        return self._exception

    def add_done_callback(self, fn: Callable[["RunHandle"], None]) -> None:
        """Call ``fn(handle)`` once the handle reaches a terminal state
        (done, errored, or cancelled).  If it already has, ``fn`` runs
        immediately on the calling thread; otherwise on whichever thread
        completes the handle.  Callback exceptions are swallowed — a
        misbehaving observer must not corrupt the dispatcher."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def _run_callbacks(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                pass

    # -- session side -------------------------------------------------------
    def _start(self) -> bool:
        """Dispatcher claims the handle; False if it was cancelled first."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _RUNNING
            return True

    def _set_result(self, result) -> None:
        with self._lock:
            if self._state in (_DONE, _CANCELLED):
                return  # terminal states are final (cancel/settle race)
            self._result = result
            self._state = _DONE
        self._event.set()
        self._run_callbacks()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._state in (_DONE, _CANCELLED):
                return  # terminal states are final (cancel/settle race)
            self._exception = exc
            self._state = _DONE
        self._event.set()
        self._run_callbacks()

    def _cascade_cancel(self) -> bool:
        """Session-side cascade: a cancelled predecessor cancels this
        still-pending dependent.  Unlike ``cancel()`` this may also claim
        a handle the dispatcher has not started (the dispatcher itself
        performs the cascade, so there is no race with ``_start``)."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
        self._event.set()
        self._run_callbacks()
        return True

    def __repr__(self) -> str:
        return (f"RunHandle({self.program_name!r}, seq={self.seq}, "
                f"state={self._state})")
