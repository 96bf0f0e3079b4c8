"""Tripping fixture for repro_torch.analysis.rng_lint — every
construction below violates a rule (negative control:
torch_rng_clean.py).  Never imported by tests; only parsed."""

import numpy as np
import torch


def nonliteral(seed):
    return np.random.default_rng(seed * 3 + 1)      # RNG001 (non-literal)


def scalar_literal():
    return np.random.default_rng(1234)              # RNG001 (raw scalar)


def unregistered_tuple():
    return np.random.default_rng((1, 2, 3))         # RNG002 (no namespace)


def raw_generator():
    return torch.Generator(device="cpu")            # RNG004 (raw root)


def global_seed():
    torch.manual_seed(0)                            # RNG004 (global root)


def reseed(gen):
    return gen.manual_seed(7)                       # RNG004 (re-rooted)
