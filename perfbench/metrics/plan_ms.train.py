"""The round planner's host time (Alg. 4 clustering with Alg. 3's
spectrum, ``core/resource.py``), a round of the window on average: the
benchmark's span around the program's ``gibbs_clustering`` call."""
from perfbench.harness.readers import window_rounds


def read(rec):
    spans = window_rounds(rec, "plan")
    return 1e3 * sum(spans) / len(spans) if spans else None
