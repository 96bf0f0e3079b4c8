"""The device trace of a ``--trace 1`` run: ``torch.profiler`` sessions
over the card alone (no host ops: tracing them inflates a host-heavy step
and takes minutes to post-process), one a traced span of the window.

A session keeps its wall time on the host clock (from a synchronised
start to a synchronised stop) and the card's events: kernels, copies and
sets, each (name, start us, duration us, kind).
"""
from __future__ import annotations

import time


class Session:
    def __init__(self, phase: str):
        self.phase = phase
        self.wall_s = 0.0
        self.events = []
        self._prof = None
        self._t0 = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        return self

    def collect(self):
        """Read the card's events out of the profiler, once."""
        if self._prof is None:
            return self
        prof, self._prof = self._prof, None
        out = []
        for e in prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()) or (
                    hasattr(e, "is_user_annotation")
                    and e.is_user_annotation()):
                continue
            name = e.name()
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            out.append((name, e.start_ns() / 1e3, e.duration_ns() / 1e3,
                        kind))
        out.sort(key=lambda ev: ev[1])
        self.events = out
        return self

    def kernels(self):
        return [e for e in self.events if e[3] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which the card ran something: the union of the
        events' intervals."""
        total, end = 0.0, None
        for _, start, dur, _ in self.events:
            stop = start + dur
            if end is None or start >= end:
                total += dur
                end = stop
            elif stop > end:
                total += stop - end
                end = stop
        return total / 1e6

    def gaps(self):
        """[(label, seconds)] of the card's idle stretches between events,
        each labelled by the events on either side."""
        out, prev, end = [], None, None
        for name, start, dur, _ in self.events:
            if end is not None and start > end:
                out.append((f"{prev[:60]} -> {name[:60]}",
                            (start - end) / 1e6))
            if end is None or start + dur > end:
                end, prev = start + dur, name
        return out


def busy_share(sessions) -> float:
    wall = sum(s.wall_s for s in sessions)
    return sum(s.busy_s() for s in sessions) / wall if wall > 0 else None


def breakdown(sessions, top: int = 10) -> dict:
    by_name = {}
    for s in sessions:
        for name, _, dur, _ in s.events:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted((g for s in sessions for g in s.gaps()),
                  key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
