"""Kernels the card ran a decode step (``serving/engine.py``'s decode
loop), counted by the profiler over the traced decode steps."""


def read(rec):
    steps = rec.counters.get("decode_steps", 0)
    sessions = rec.sessions_of("decode")
    if not steps or not sessions:
        return None
    return sum(len(s.kernels()) for s in sessions) / steps
