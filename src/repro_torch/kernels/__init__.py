"""The port's hand-written kernels and what their wrappers share."""
from __future__ import annotations

import torch

# the observers of kernel calls, spans and counters live with the tracer;
# ``kernels.observers`` is the same list
from repro_torch.telemetry import observers, record_call  # noqa: F401


def no_grad_inputs(name: str, *tensors):
    """Raise when grad mode is on and an input requires grad: a kernel
    wrapper's output is not differentiable, so autograd would silently
    treat it as a constant. Training reaches the kernels through the
    ``autograd.Function``s in ``kernels/*/ops.py``, whose forwards run
    with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the kernel has no backward. "
            "Call it through its autograd.Function in kernels/*/ops.py")


