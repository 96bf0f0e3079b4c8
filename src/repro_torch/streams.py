"""Random streams of the port: ``torch.Generator`` roots.

Counterparts of ``repro.streams.model_key`` and ``repro.streams.sampler_key``.
A torch generator does not reproduce JAX's threefry draws from the same
seed, so tests that compare the two packages make their inputs with numpy
and convert the reference's parameters instead of drawing them here. The
NumPy stream registry comes with the CPSL slice.
"""
from __future__ import annotations

import torch


def model_generator(seed: int, device="cuda") -> torch.Generator:
    """Model-parameter init root for ``models.api.init``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sampler_generator(seed: int, device="cuda") -> torch.Generator:
    """Prompt and token-sampling root for the serving demo."""
    return torch.Generator(device=device).manual_seed(int(seed))
