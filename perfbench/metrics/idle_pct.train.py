"""The card's idle share over the traced rounds (plan included)."""
from perfbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec, "round")
