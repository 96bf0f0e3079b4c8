"""Negative control for repro_torch.analysis.rng_lint — every
construction below is allowed.  Never imported by tests; only parsed."""

import numpy as np
import torch

from repro_torch import streams


def registered_root():
    return streams.model_generator(0, "cpu")


def registered_constructor():
    return streams.chain_rng(0, 3)


def literal_registered_tuple():
    # matches the fleet_departures pattern (Sym(seed), Sym(episode), 11)
    return np.random.default_rng((0, 7, 11))


def os_entropy():
    # unseeded: OS entropy, no namespace to police
    return np.random.default_rng()


def draw(gen):
    # drawing from a registered root is not a construction
    return torch.randn(3, generator=gen)
