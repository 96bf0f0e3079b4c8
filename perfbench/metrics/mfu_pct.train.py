"""The model FLOPs of the window's rounds (training form: 6 N_active
tokens plus the SSD state term, no recompute counted) over the rounds'
wall time and the card's bf16 peak."""
from perfbench.harness import work
from perfbench.harness.readers import window_rounds


def read(rec):
    spans = window_rounds(rec, "round")
    if not spans:
        return None
    flops = rec.counters["model_flops_round"] * len(spans)
    return 100.0 * flops / sum(spans) / work.PEAK_FLOPS_BF16
