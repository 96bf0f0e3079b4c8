"""What the readers of the mixers' spans share: ``mamba`` around each
Mamba-2 mixer call (``models/mamba2.py``), ``attn`` around each attention
mixer call (``models/transformer.py``)."""
from __future__ import annotations

from perfbench.harness.spans import program_spans, share_pct


def mixer_pct(phase: str, name: str):
    """100 x the device time of the spans ``name`` under ``phase`` over
    that of the spans ``phase``; None where the program has no span
    ``name`` (a program without the mixers' spans)."""
    spans = program_spans()
    if spans is None or not any(s.name == name for s in spans):
        return None
    return share_pct(phase, name)
