"""The Mamba-2 mixer's gated output stage in plain PyTorch, beside the
hand-written kernel (``csrc/gated_norm.cu``):

    out = rmsnorm((y + D[h] x) silu(z)) scale

over rows of width W = H P, y and x in the heads' layout (..., H, P) and
z in the rows' (..., W), as the mixer has them. ``gated_norm_ref`` is the
mixer's expression op for op (the CPU path and the tests' oracle);
``gated_norm_bwd_ref`` is the backward the kernel computes, in closed
form."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gated_norm_ref(y, x, z, D, scale, eps: float):
    """y, x (..., H, P) and z (..., W = H P) in one dtype, D (H,), scale
    (W,): the skip ``y + x D`` in y's dtype, the SiLU gate, then RMSNorm
    in f32 (``models.common.apply_norm``'s; f64 for f64 rows), rounded
    back to y's dtype. Returns (..., W)."""
    g = (y + x * D.to(y.dtype)[:, None]).reshape(z.shape) * F.silu(z)
    up = torch.Tensor.double if g.dtype == torch.float64 else \
        torch.Tensor.float
    gf = up(g)
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * up(scale)).to(y.dtype)


def gated_norm_bwd_ref(y, x, z, D, scale, rstd, dout):
    """The stage's gradients from dout ((..., W), as z), given the
    forward's rstd (rows,) = rsqrt(mean(g^2) + eps): dy and dx in y's
    shape, dz in z's, all three in y's dtype; dD (H,) and dscale (W,) in
    f32 (f64 for f64 inputs). With n = g rstd, dn = dout scale and
    m = mean(n dn): dg = rstd (dn - n m), dy = dg silu(z), dx = D dy,
    dz = dg (y + D x) silu'(z), dD = the sum of dy x over each head's
    columns, dscale = the sum of dout n over the rows."""
    f = torch.promote_types(y.dtype, torch.float32)
    H, P = y.shape[-2:]
    W = H * P
    yf, xf, zf, df = (t.to(f).reshape(-1, H, P) for t in (y, x, z, dout))
    d = D.to(y.dtype).to(f)[:, None]
    r = rstd.to(f).reshape(-1, 1, 1)
    u = yf + d * xf
    sig = torch.sigmoid(zf)
    s = zf * sig
    n = u * s * r
    dn = df * scale.to(f).reshape(H, -1)
    m = (n * dn).sum((-2, -1), keepdim=True) / W
    dg = r * (dn - n * m)
    dy = dg * s
    dz = dg * u * sig * (1 + zf * (1 - sig))
    dD = (dy * xf).sum((0, 2))
    dscale = (df * n).sum(0).reshape(W)
    return (dy.reshape(y.shape).to(y.dtype),
            (d * dy).reshape(y.shape).to(y.dtype),
            dz.reshape(z.shape).to(y.dtype), dD, dscale)
