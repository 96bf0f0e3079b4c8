"""What the per-layer readers (``metrics/<name>.py``) share."""
from __future__ import annotations

from perfbench.harness import trace, work


def idle_pct(rec, phase: str):
    """The card's idle share over the traced sessions of ``phase``."""
    sessions = rec.sessions_of(phase)
    share = trace.busy_share(sessions) if sessions else None
    return None if share is None else 100.0 * (1.0 - share)


def roofline_pct(rec, phase: str, call: str, kernels: tuple, work_fn):
    """The calls' least time on the card (the larger of FLOPs over the
    peak and bytes over the bandwidth, summed over the calls) over the
    device time of the kernels named ``kernels`` in the sessions of
    ``phase``. None where no call was seen; an error where calls were
    seen and no kernel of those names ran."""
    calls = rec.calls_of(phase, call)
    if not calls:
        return None
    bound = sum(work.bound_s(*work_fn(ops, res)) for _, _, ops, res in calls)
    busy = sum(dur for s in rec.sessions_of(phase)
               for name, _, dur, _ in s.kernels()
               if any(k in name for k in kernels)) / 1e6
    if busy <= 0:
        raise RuntimeError(f"{len(calls)} {call} calls seen in {phase} and "
                           f"no kernel named {kernels} in its trace")
    return 100.0 * bound / busy


def window_rounds(rec, span: str):
    """The last ``rounds`` values of ``span``: the window's, not set-up's."""
    n = int(rec.counters["rounds"])
    return rec.spans[span][-n:]
