"""The MoE layers' share of the decode steps' device time
(``models/common.py::moe_apply`` with ``no_drop``: every expert computes
g k slots): the program's spans ``moe`` under ``serve.decode`` over those
``serve.decode``."""
from perfbench.harness.spans import share_pct


def read(rec):
    return share_pct("serve.decode", "moe")
