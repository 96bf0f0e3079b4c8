"""The card's idle share over the traced prefills (from each generate
call to its first token)."""
from perfbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec, "prefill")
