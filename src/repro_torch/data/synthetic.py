"""Synthetic datasets (the container is offline — no MNIST download).

``synthetic_mnist`` procedurally generates a learnable 10-class 28x28
image set: each class is a smooth random frequency blob; samples add
shifts + noise. The CPSL/SL/FL *relative* convergence behaviour the paper
studies is preserved (same dims, counts, and non-IID protocol).

``non_iid_split`` implements the paper's protocol: each device holds
``samples_per_device`` samples drawn from 3 random classes (§VIII-A).

``MarkovLM`` makes LM token batches from an order-1 Markov chain, so a
split LM's loss can fall.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch import streams


def synthetic_mnist(n_train: int = 50_000, n_test: int = 10_000,
                    n_classes: int = 10, hw: int = 28, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    rng = streams.data_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw),
                         indexing="ij")
    protos = []
    for c in range(n_classes):
        acc = np.zeros((hw, hw))
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            acc += rng.uniform(0.5, 1.0) * np.sin(fx * np.pi * xx + px) \
                * np.cos(fy * np.pi * yy + py)
        acc += np.exp(-((xx - rng.uniform(-0.4, 0.4)) ** 2
                        + (yy - rng.uniform(-0.4, 0.4)) ** 2) / 0.15)
        protos.append(acc / np.abs(acc).max())
    protos = np.stack(protos)

    def gen(n, seed2):
        r = streams.data_rng(seed2)
        labels = r.integers(0, n_classes, n)
        imgs = protos[labels]
        # random shifts
        sx = r.integers(-2, 3, n)
        sy = r.integers(-2, 3, n)
        out = np.empty((n, hw, hw), np.float32)
        for i in range(n):
            out[i] = np.roll(np.roll(imgs[i], sx[i], 0), sy[i], 1)
        out += r.normal(0, 0.35, out.shape)
        return out[..., None].astype(np.float32), labels.astype(np.int32)

    xtr, ytr = gen(n_train, seed + 1)
    xte, yte = gen(n_test, seed + 2)
    return xtr, ytr, xte, yte


def non_iid_split(labels: np.ndarray, n_devices: int = 30,
                  classes_per_device: int = 3,
                  samples_per_device: int = 180, n_classes: int = 10,
                  seed: int = 0) -> List[np.ndarray]:
    """Paper §VIII-A: each device gets `samples_per_device` samples from 3
    randomly chosen classes. Returns per-device index arrays."""
    rng = streams.data_rng(seed)
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    out = []
    for _ in range(n_devices):
        cls = rng.choice(n_classes, classes_per_device, replace=False)
        per = samples_per_device // classes_per_device
        idx = np.concatenate([
            rng.choice(by_class[c], per, replace=False) for c in cls])
        rng.shuffle(idx)
        out.append(idx.astype(np.int64))
    return out


# --------------------------------------------------------------------------
# synthetic LM tokens (Markov-ish so loss can decrease)
# --------------------------------------------------------------------------

class MarkovLM:
    """Order-1 Markov chain over a small effective vocab embedded in the
    model's (possibly huge) vocab; yields (tokens, labels) batches."""

    def __init__(self, vocab_size: int, eff_vocab: int = 256, seed: int = 0):
        rng = streams.data_rng(seed)
        self.eff = min(eff_vocab, vocab_size)
        self.vocab_size = vocab_size
        logits = rng.normal(0, 1.5, (self.eff, self.eff))
        p = np.exp(logits - logits.max(1, keepdims=True))
        self.P = p / p.sum(1, keepdims=True)
        self.cum = np.cumsum(self.P, axis=1)

    def sample(self, batch: int, seq: int, rng: np.random.Generator):
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.eff, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            toks[:, t + 1] = (u[:, t, None]
                              < self.cum[toks[:, t]]).argmax(1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
