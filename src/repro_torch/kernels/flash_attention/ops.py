"""Grouped-layout flash attention over the flat-head kernel, as a
``torch.autograd.Function`` (the reference's ``custom_vjp``,
``repro/kernels/flash_attention/ops.py``): the forward launches the kernel
(K1); the backward recomputes through ``models.common.chunked_attention``,
whose own flash backward keeps memory at O(chunk^2). No dq/dk/dv kernel:
the reference's backward is plain jnp too."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_flat


def _forward(q, k, v, causal, window, softcap, q_offset) -> torch.Tensor:
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


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, q_offset)
        return _forward(q, k, v, causal, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.common import chunked_attention
        q, k, v = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = chunked_attention(*inputs, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    q_offset=0) -> torch.Tensor:
    """Grouped layout: q (B, Sq, G, R, D); k, v (B, Skv, G, D). Returns
    (B, Sq, G, R, D) in q's dtype; differentiable in q, k and v (dk and dv
    summed over each kv head's R query heads)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)
