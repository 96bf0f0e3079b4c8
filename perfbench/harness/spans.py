"""What the readers of the program's own spans and counters share
(``repro_torch.telemetry``: spans at the layer boundaries of a CPSL round
and of a serve call, on the profiler's clock).

A program without the tracer has no spans: every reader then returns
None and raises nothing.
"""
from __future__ import annotations

import numpy as np


def program_spans():
    """The program's closed spans (``telemetry.spans()``), or None where
    the program has no tracer or recorded nothing."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "spans", None)
    spans = read() if read is not None else None
    return spans or None


def per_round_ms(rec, names, per: str):
    """The spans ``names``' seconds (``rec.spans``: device seconds where
    timed) summed, in ms a span ``per``; None where any is missing."""
    if not rec.spans.get(per):
        return None
    if not all(rec.spans.get(n) for n in names):
        return None
    return 1e3 * sum(sum(rec.spans[n]) for n in names) / len(rec.spans[per])


def under(spans, phase: str):
    """The spans whose nearest ancestor of the name ``phase`` exists:
    {span id: that ancestor's id}."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        p = s.parent
        while p is not None and by_id[p].name != phase:
            p = by_id[p].parent
        if p is not None:
            out[s.id] = p
    return out


def share_pct(phase: str, name: str):
    """100 x the seconds of the spans ``name`` under ``phase`` over the
    seconds of the spans ``phase``."""
    spans = program_spans()
    if spans is None:
        return None
    total = sum(s.seconds for s in spans if s.name == phase)
    inner = under(spans, phase)
    part = sum(s.seconds for s in spans
               if s.name == name and s.id in inner)
    return 100.0 * part / total if total > 0 else None


def counters_under(phase: str, name: str, keys) -> dict:
    """The counters ``keys`` summed over the spans ``name`` under
    ``phase``; None where no such span counted."""
    spans = program_spans()
    if spans is None:
        return None
    inner = under(spans, phase)
    out = dict.fromkeys(keys, 0)
    seen = False
    for s in spans:
        if s.name == name and s.id in inner and s.counters:
            seen = True
            for k in keys:
                out[k] += s.counters.get(k, 0)
    return out if seen else None


def _events(sessions):
    """(starts, ends) in us of the sessions' events, in time order."""
    n = sum(len(s.events) for s in sessions)
    starts = np.fromiter((e[1] for s in sessions for e in s.events),
                         np.float64, n)
    durs = np.fromiter((e[2] for s in sessions for e in s.events),
                       np.float64, n)
    order = np.argsort(starts, kind="stable")
    return starts[order], starts[order] + durs[order]


def idle_within(sessions, intervals) -> float:
    """Seconds in which the card ran nothing while the host was inside one
    of ``intervals`` ((start ns, end ns), disjoint, on the profiler's
    clock), from the sessions' events in one linear pass."""
    if not intervals:
        return 0.0
    iv = np.asarray(sorted(intervals), np.float64) / 1e3      # us
    starts, ends = _events(sessions)
    lo, hi = iv[0, 0], iv[-1, 1]
    if starts.size == 0:
        gs, ge = np.array([lo]), np.array([hi])
    else:
        reach = np.maximum.accumulate(ends)       # busy up to here
        gs = np.concatenate([[min(lo, starts[0])], reach])
        ge = np.concatenate([starts, [max(hi, reach[-1])]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
    # idle time before x: whole gaps ending before it, and part of one
    cum = np.concatenate([[0.0], np.cumsum(ge - gs)])

    def idle_before(x):
        k = np.searchsorted(ge, x, side="right")
        part = np.where(k < gs.size,
                        np.clip(x - gs[np.minimum(k, gs.size - 1)], 0.0,
                                None), 0.0)
        return cum[k] + part
    return float(np.sum(idle_before(iv[:, 1]) - idle_before(iv[:, 0]))) \
        / 1e6


def idle_in_spans_pct(rec, phase: str, name: str):
    """100 x the card's idle time in the sessions of ``phase`` while the
    host was inside a span ``name``, over the sessions' wall."""
    spans = program_spans()
    sessions = rec.sessions_of(phase)
    if spans is None or not sessions:
        return None
    intervals = [(s.host_start_ns, s.host_end_ns) for s in spans
                 if s.name == name]
    wall = sum(s.wall_s for s in sessions)
    if not intervals or wall <= 0:
        return None
    return 100.0 * idle_within(sessions, intervals) / wall


def token_gaps_ms():
    """The gaps in ms between consecutive tokens' ``serve.sample`` spans of
    each ``serve.generate``, end to end (device ends where timed, else host
    ends)."""
    spans = program_spans()
    if spans is None:
        return None
    ends = {}
    for s in spans:
        if s.name != "serve.sample":
            continue
        t = (s.device_end_ms if s.device_end_ms is not None
             else s.host_end_ns / 1e6)
        ends.setdefault(s.root, []).append((s.id, t))
    roots = {s.id for s in spans if s.name == "serve.generate"}
    gaps = []
    for r, marks in ends.items():
        if r in roots:
            t = np.array([m[1] for m in sorted(marks)])
            gaps.extend(np.diff(t).tolist())
    return gaps or None
