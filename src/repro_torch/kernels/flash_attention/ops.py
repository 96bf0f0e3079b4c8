"""Grouped-layout flash attention over the flat-head kernel (forward only;
the autograd.Function whose backward recomputes through chunked_attention
comes with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_flat


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    q_offset=0) -> torch.Tensor:
    """Grouped layout: q (B, Sq, G, R, D); k, v (B, Skv, G, D)."""
    B, Sq, G, R, D = q.shape
    Skv = k.shape[1]
    # flat heads, contiguous: with B = 1 the reshapes alone are strided
    # views, which the kernel does not take
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * G * R, Sq, D).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * G, Skv, D).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * G, Skv, D).contiguous()
    of = flash_attention_flat(qf, kf, vf, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset,
                              kv_repeat=R)
    return of.reshape(B, G, R, Sq, D).permute(0, 3, 1, 2, 4)
