"""The card's idle time in the traced rounds while the host was inside
``CPSL.run_round`` (the program's root span ``cpsl.round``; the plan
before it is left out), over the sessions' wall: the share of
``idle_pct.train`` the round itself leaves."""
from perfbench.harness.spans import idle_in_spans_pct


def read(rec):
    return idle_in_spans_pct(rec, "round", "cpsl.round")
