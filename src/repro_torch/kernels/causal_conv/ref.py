"""The Mamba-2 mixer's causal depthwise conv with its SiLU in plain
PyTorch, beside the hand-written kernel (``csrc/causal_conv.cu``):

    y = silu(b + sum_k w[k] x[t - (K - 1) + k])

over each sequence of x (B, S, C), zeros before its first row.
``causal_conv`` and ``causal_conv_silu_ref`` are the mixer's expression op
for op (the CPU path and the tests' oracle); ``causal_conv_bwd_ref`` is the
backward the kernel computes, in closed form."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv(x, w, b):
    """x: (B,S,C), w: (K,C), b: (C,) — causal depthwise conv, summed in
    x's dtype tap by tap, as the reference does (so bf16 rounds alike)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, k:k + S, :] * w[k].to(x.dtype) for k in range(K))
    return y + b.to(x.dtype)


def causal_conv_silu_ref(x, w, b):
    """The mixer's conv stage, ``silu(causal_conv(x, w, b))``, in x's
    dtype."""
    return F.silu(causal_conv(x, w, b))


def causal_conv_bwd_ref(x, w, b, dy):
    """The stage's gradients from dy (B, S, C), with the taps and bias
    rounded to x's dtype as the forward rounds them: dx in x's shape and
    dtype, dw (K, C) and db (C,) in f32 (f64 for f64 inputs). With p the
    pre-activation in f32 and g = dy silu'(p) (zero past the sequence):
    dx[t] = sum_k w[k] g[t + K - 1 - k], dw[k] = the sum over the rows of
    g[t] x[t - (K - 1) + k], db = the sum of g."""
    f = torch.promote_types(x.dtype, torch.float32)
    K, S = w.shape[0], x.shape[1]
    wf, bf = w.to(x.dtype).to(f), b.to(x.dtype).to(f)
    xp = F.pad(x.to(f), (0, 0, K - 1, 0))
    p = bf + sum(xp[:, k:k + S] * wf[k] for k in range(K))
    s = torch.sigmoid(p)
    g = dy.to(f) * s * (1 + p * (1 - s))
    gp = F.pad(g, (0, 0, 0, K - 1))
    dx = sum(gp[:, K - 1 - k:K - 1 - k + S] * wf[k] for k in range(K))
    dw = torch.stack([(g * xp[:, k:k + S]).sum((0, 1)) for k in range(K)])
    return dx.to(x.dtype), dw, g.sum((0, 1))
