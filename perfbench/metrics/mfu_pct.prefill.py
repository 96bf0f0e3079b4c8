"""The model FLOPs of the window's prefills (prefill form: 2 N_active
tokens plus attention at half the prompt) over their time (each call's
time to its first token) and the card's bf16 peak."""
from perfbench.harness import work


def read(rec):
    spans = rec.spans.get("ttft", [])
    if not spans:
        return None
    flops = rec.counters["model_flops_prefill"] * len(spans)
    return 100.0 * flops / sum(spans) / work.PEAK_FLOPS_BF16
