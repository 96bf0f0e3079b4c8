"""The share of the rounds' device time in K2's ``autograd.Function``
backward (``kernels/ssd/ops.py``: the plain recomputing scan): the
program's spans ``ssd.bwd`` over its spans ``cpsl.round``."""


def read(rec):
    bwd, rounds = rec.spans.get("ssd.bwd"), rec.spans.get("cpsl.round")
    if not bwd or not rounds:
        return None
    return 100.0 * sum(bwd) / sum(rounds)
