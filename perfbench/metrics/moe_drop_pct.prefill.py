"""The share of the prefills' routed choices the MoE dispatch dropped
past its capacity: 100 (1 - kept / choices), from the program's counters
``moe.kept`` and ``moe.choices`` on its spans ``moe`` under
``serve.prefill``."""
from perfbench.harness.spans import counters_under


def read(rec):
    c = counters_under("serve.prefill", "moe", ("moe.kept", "moe.choices"))
    if not c or not c["moe.choices"]:
        return None
    return 100.0 * (1.0 - c["moe.kept"] / c["moe.choices"])
