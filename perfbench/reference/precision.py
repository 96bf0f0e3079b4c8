"""The precision a reference computes its products in.

``float32`` is the reference itself. ``fp8`` is the control: every
matrix product takes its operands rounded to float8 e4m3 (gradients to
e5m2 in the backward), each tensor scaled by its own absolute maximum as
fp8 training scales it, and so do the SSD scan's inputs and attention's
q, k and v: the step below the bfloat16 that the configurations state,
the one that would tempt a later change. Accumulation stays in float32.
"""
from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_MAX = {E4M3: 448.0, E5M2: 57344.0}


def quantize(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under a per-tensor scale, back in f32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _MAX[fmt], torch.ones_like(amax))
    return (t / scale).to(fmt).float() * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return quantize(t, E4M3)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, E5M2)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, E4M3), quantize(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, E5M2)
        ga = qg @ qb.transpose(-1, -2)
        a2 = qa.reshape(-1, qa.shape[-1])
        gb = a2.transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape)


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(name)
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ b (k, n)."""
        if self.name == "float32":
            return a @ b
        return _Matmul.apply(a, b)

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation the program holds in bfloat16 (the SSD scan's and
        attention's inputs)."""
        return t if self.name == "float32" else _Round.apply(t)
