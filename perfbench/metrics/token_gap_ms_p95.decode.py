"""The 95th percentile of the single gaps between consecutive tokens of a
call, each the time between two tokens' ``serve.sample`` spans' device
ends (the token ready on the card; ``serving/engine.py``)."""
import numpy as np

from perfbench.harness.spans import token_gaps_ms


def read(rec):
    gaps = token_gaps_ms()
    return float(np.percentile(gaps, 95)) if gaps else None
