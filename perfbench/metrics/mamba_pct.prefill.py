"""The Mamba-2 mixers' share of the prefills' device time
(``models/mamba2.py::mamba_apply``: in_proj, conv, K2, the gated norm,
out_proj): the program's spans ``mamba`` under ``serve.prefill`` over
those ``serve.prefill``."""
from perfbench.harness.mixer_spans import mixer_pct


def read(rec):
    return mixer_pct("serve.prefill", "mamba")
