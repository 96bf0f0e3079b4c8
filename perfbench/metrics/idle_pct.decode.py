"""The card's idle share over the traced decode steps (from each call's
first token to its last)."""
from perfbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec, "decode")
