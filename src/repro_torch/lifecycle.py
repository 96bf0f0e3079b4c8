"""Graceful shutdown for long-running loops (the port of
``repro.lifecycle.GracefulStop``; the retry and backoff helpers come with
the runtime, ROADMAP slice 8).

A ``GracefulStop`` turns SIGTERM into a thread-safe flag that loops poll
at their next safe point instead of dying mid-write:
``train.trainer.CPSLTrainer`` checkpoints and exits on it at a round
boundary.

Signal handlers can only be installed from the main thread; elsewhere
(e.g. a trainer constructed inside a test worker thread) ``install``
degrades to a manually-triggerable flag. Previously-installed handlers
are chained so stacking a GracefulStop on top of a host framework's own
SIGTERM hook doesn't swallow it.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable


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
