"""The card's idle time in the traced decodes while the host was inside a
decode step (the program's spans ``serve.decode``; the token's sample
and its wait are left out), over the sessions' wall."""
from perfbench.harness.spans import idle_in_spans_pct


def read(rec):
    return idle_in_spans_pct(rec, "decode", "serve.decode")
