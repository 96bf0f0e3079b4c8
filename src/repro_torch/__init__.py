"""PyTorch/CUDA port of the ``repro`` package, module for module.

Entry points take a ``device`` that defaults to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for ``"cpu"``. The port imports
``torch`` and never JAX or the ``repro`` package.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises for a CUDA device on a
    host without CUDA: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
