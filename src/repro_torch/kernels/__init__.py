"""The port's hand-written kernels and what their wrappers share."""
from __future__ import annotations

import torch


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


# Observers of hand-kernel calls (``launch.hlo_analysis.OpCounter`` adds
# itself while it counts): a launch through ctypes is no aten op, so each
# wrapper reports its kernel here, on the card and on its meta path.
observers = []


def record_call(name: str, operands, results):
    """Report one kernel call (its operand and result tensors) to every
    observer."""
    for obs in observers:
        obs.custom_call(name, operands, results)
