"""The attention mixers' share of the prefills' device time
(``models/transformer.py``'s attention layers: the q, k, v projections,
the cache write, K1, the output projection): the program's spans
``attn`` under ``serve.prefill`` over those ``serve.prefill``."""
from perfbench.harness.mixer_spans import mixer_pct


def read(rec):
    return mixer_pct("serve.prefill", "attn")
