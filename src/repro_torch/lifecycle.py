"""Graceful shutdown and retry/backoff plumbing shared by the trainer and
the rt runtime (the port of ``repro.lifecycle``).

A ``GracefulStop`` turns SIGTERM into a thread-safe flag that loops poll
at their next safe point instead of dying mid-write:
``train.trainer.CPSLTrainer`` checkpoints and exits on it at a round
boundary.

Signal handlers can only be installed from the main thread; elsewhere
(e.g. a trainer constructed inside a test worker thread) ``install``
degrades to a manually-triggerable flag. Previously-installed handlers
are chained so stacking a GracefulStop on top of a host framework's own
SIGTERM hook doesn't swallow it.

``Backoff`` / ``retry_sleeps`` / ``retry_budget_s`` hold the capped
exponential-backoff arithmetic of the rt stack: the device RPC loop, the
worker-reconnect dialer and the orchestrator's respawn monitor draw their
delays from here, and ``rt.orchestrator.RTConfig.validate`` uses
``retry_budget_s`` to refuse configs whose device-side retry budget
crosses the server's straggler deadline (the device would still be
retrying a phase the server already gave up on).
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, List


def retry_sleeps(retries: int, backoff0: float,
                 cap: float = float("inf")) -> List[float]:
    """The sleep before each re-attempt ``a = 1..retries``:
    ``min(backoff0 * 2**(a-1), cap)``: exponential, capped, and monotone
    non-decreasing."""
    return [min(backoff0 * (2.0 ** a), cap) for a in range(retries)]


def retry_budget_s(timeout_s: float, retries: int, backoff0: float,
                   cap: float = float("inf")) -> float:
    """Worst-case wall-clock one RPC can spend before giving up:
    ``retries + 1`` reply waits of ``timeout_s`` plus the backoff sleeps
    between them. A server phase deadline must exceed this or the two
    ends disagree about who timed out first."""
    return (retries + 1) * timeout_s + sum(retry_sleeps(retries, backoff0,
                                                        cap))


class Backoff:
    """Stateful capped exponential backoff (respawn / reconnect pacing):
    ``next()`` returns the current delay and doubles it up to ``cap``;
    ``reset()`` re-arms after a success."""

    def __init__(self, initial: float = 0.25, cap: float = 5.0):
        self.initial = float(initial)
        self.cap = float(cap)
        self._cur = self.initial

    def next(self) -> float:
        d = self._cur
        self._cur = min(self._cur * 2.0, self.cap)
        return d

    def reset(self):
        self._cur = self.initial


class GracefulStop:
    def __init__(self):
        self._event = threading.Event()
        self._chained = {}

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def __bool__(self) -> bool:
        return self.triggered

    def trigger(self, signum=None, frame=None):
        """Signal-handler entrypoint; also callable directly (tests, or
        a parent orchestrator asking a worker loop to wind down)."""
        self._event.set()
        prev = self._chained.get(signum)
        if callable(prev):
            prev(signum, frame)

    def wait(self, timeout: float) -> bool:
        return self._event.wait(timeout)

    def install(self, signals: Iterable[int] = (signal.SIGTERM,)
                ) -> "GracefulStop":
        for sig in signals:
            try:
                prev = signal.signal(sig, self.trigger)
            except ValueError:      # not the main thread
                continue
            if prev not in (signal.SIG_DFL, signal.SIG_IGN, None):
                self._chained[sig] = prev
        return self
