"""The Mamba-2 mixer's causal conv and SiLU as a ``torch.autograd.Function``
over the hand-written kernels (``kernel.causal_conv_fwd``,
``kernel.causal_conv_bwd``; the reference has no kernel here, its conv is
plain jnp).

``causal_conv_silu`` dispatches by where the tensors lie: CUDA and
``meta`` tensors go through the Function (on ``meta`` the wrappers
allocate what the card would, compute nothing and report the calls, so
the dry run counts the kernels' bytes); CPU tensors take the plain
expression, ``ref.causal_conv_silu_ref``, under autograd."""
from __future__ import annotations

import torch

from repro_torch.kernels.causal_conv.kernel import (causal_conv_bwd,
                                                    causal_conv_fwd)
from repro_torch.kernels.causal_conv.ref import causal_conv_silu_ref


class CausalConvSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = causal_conv_fwd(x, w, b)
        # x is a view of in_proj's output, whose storage the mixer keeps
        # for z anyway
        ctx.save_for_backward(x, w, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        # the split's gradient is already contiguous (no copy)
        dx, dw, db = causal_conv_bwd(x, w, b, dy.contiguous())
        return dx, dw.to(w.dtype), db.to(b.dtype)


def causal_conv_silu(x, w, b):
    """silu(causal depthwise conv of x (B, S, C) with taps w (K, C) and
    bias b (C,)), each sequence from zeros; x may be a column slice (any
    batch and row strides). Differentiable in every tensor."""
    if x.device.type == "cpu":
        return causal_conv_silu_ref(x, w, b)
    return CausalConvSiLU.apply(x, w, b)
