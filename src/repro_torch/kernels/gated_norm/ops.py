"""The Mamba-2 mixer's gated output stage as a ``torch.autograd.Function``
over the hand-written kernels (``kernel.gated_norm_fwd``,
``kernel.gated_norm_bwd``; the reference has no kernel here, its stage is
plain jnp).

``gated_norm`` dispatches by where the tensors lie: CUDA and ``meta``
tensors go through the Function (on ``meta`` the wrappers allocate what the
card would, compute nothing and report the calls, so the dry run counts
the kernels' bytes); CPU tensors take the plain expression,
``ref.gated_norm_ref``, under autograd."""
from __future__ import annotations

import torch

from repro_torch.kernels.gated_norm.kernel import (gated_norm_bwd,
                                                   gated_norm_fwd)
from repro_torch.kernels.gated_norm.ref import gated_norm_ref


class GatedNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x, z, D, scale, eps):
        out, rstd = gated_norm_fwd(y, x, z, D, scale, eps)
        ctx.save_for_backward(y, x, z, D, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, x, z, D, scale, rstd = ctx.saved_tensors
        # out_proj's gradient is already contiguous (no copy); autograd
        # hands a sum's gradient expanded, with row stride 0
        dy, dx, dz, dD, dscale = gated_norm_bwd(y, x, z, D, scale, rstd,
                                                dout.contiguous())
        return dy, dx, dz, dD.to(D.dtype), dscale.to(scale.dtype), None


def gated_norm(y, x, z, D, scale, eps: float):
    """rmsnorm((y + D[h] x) silu(z)) scale over rows of W = H P: y, x
    (..., H, P) and z (..., W) in one dtype (x and z may be column slices,
    any row stride), D (H,), scale (W,); the result has z's shape.
    Differentiable in every tensor."""
    if y.device.type == "cpu":
        return gated_norm_ref(y, x, z, D, scale, eps)
    return GatedNorm.apply(y, x, z, D, scale, eps)
