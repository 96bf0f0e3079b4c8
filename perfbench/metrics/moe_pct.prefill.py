"""The MoE layers' share of the prefills' device time
(``models/common.py::moe_apply``, the capacity-dropped dispatch): the
program's spans ``moe`` under ``serve.prefill`` over those
``serve.prefill``."""
from perfbench.harness.spans import share_pct


def read(rec):
    return share_pct("serve.prefill", "moe")
