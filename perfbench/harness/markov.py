"""Synthetic LM tokens from an order-1 Markov chain over a small effective
vocabulary: a frozen copy of the sampler of the program's
``data/synthetic.py::MarkovLM``, seeded here, so that no change to the
program changes the traffic."""
from __future__ import annotations

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size: int, eff_vocab: int, rng):
        self.eff = min(eff_vocab, vocab_size)
        logits = rng.normal(0, 1.5, (self.eff, self.eff))
        p = np.exp(logits - logits.max(1, keepdims=True))
        self.cum = np.cumsum(p / p.sum(1, keepdims=True), axis=1)

    def sample(self, rows: int, seq: int, rng) -> np.ndarray:
        """(rows, seq + 1) int64 tokens: inputs [:, :-1], labels [:, 1:]."""
        toks = np.empty((rows, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.eff, rows)
        u = rng.random((rows, seq))
        for t in range(seq):
            toks[:, t + 1] = (u[:, t, None] < self.cum[toks[:, t]]).argmax(1)
        return toks
