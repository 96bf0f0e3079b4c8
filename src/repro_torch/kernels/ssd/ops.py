"""SSD in the model's layout over the kernel, as a
``torch.autograd.Function`` (the reference's ``custom_vjp``,
``repro/kernels/ssd/ops.py``): the forward launches the kernel (K2).

The backward takes what it can see in the saved inputs. bf16 tensors on
the card take the backward kernel (``bwd.ssd_bwd``, ``csrc/ssd_bwd.cu``;
the reference has none, its backward is plain jnp), and so do bf16
tensors on ``meta``: there the wrapper allocates what the card would,
computes nothing and reports the call, so the dry run counts what the
card runs, as the forward's meta path does. Float32 tensors, on the card
or the CPU, and every CPU tensor recompute through
``models.mamba2.ssd_chunked``, whose chunk bodies are checkpointed, so no
(B, H, Q, Q) tile is stashed: float32 is the reduced models' exact check
(a split-LM round on the card against the CPU within 1e-4 a leaf), which
the kernel's bf16 hi + lo products (~16 bits) would not hold. Traced,
each backward is the span ``ssd.bwd``."""
from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.kernels.ssd.bwd import ssd_bwd
from repro_torch.kernels.ssd.kernel import ssd_grouped


class SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        # an output that gets no gradient arrives as None, not zeros
        ctx.set_materialize_grads(False)
        return ssd_grouped(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    @telemetry.spanned("ssd.bwd")
    def backward(ctx, gy, ghT):
        saved = ctx.saved_tensors      # unpacked once (remat checkpoints)
        x = saved[0]
        if x.device.type in ("cuda", "meta") and x.dtype == torch.bfloat16:
            # a backward that reaches only hT: y's gradient is zero, and
            # hT does not depend on C
            dx, ddt, dA, dB, dC = ssd_bwd(
                *saved, torch.zeros_like(x) if gy is None else gy, ghT,
                chunk=ctx.chunk)
            return dx, ddt, dA, dB, None if gy is None else dC, None
        from repro_torch.models.mamba2 import _broadcast_groups, ssd_chunked
        inputs = [t.detach().requires_grad_() for t in saved]
        x, dt, A, Bm, Cm = inputs
        H = x.shape[2]
        with torch.enable_grad():
            # per-group B and C broadcast to heads: autograd sums dB and
            # dC over each group's heads
            y, hT = ssd_chunked(x, dt, A, _broadcast_groups(Bm, H),
                                _broadcast_groups(Cm, H), chunk=ctx.chunk)
            outs, grads = zip(*[(o, g) for o, g in ((y, gy), (hT, ghT))
                                if g is not None])
            # hT alone does not depend on C
            dx, ddt, dA, dB, dC = torch.autograd.grad(outs, inputs, grads,
                                                      allow_unused=True)
        return dx, ddt, dA, dB, dC, None


def ssd(x, dt, A, Bm, Cm, chunk: int = 128, h0=None):
    """Model layout: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) per
    group, G dividing H (per-head B and C are the case G = H). x and dt
    may be strided views; nothing is copied or broadcast in the forward.
    Returns (y (B,S,H,P), final state (B,H,N,P)), both differentiable in
    every input. The kernel starts from a zero state, so ``h0`` must be
    None (prefill from scratch); decode carries the state through
    ``models.mamba2.ssd_decode_step``."""
    if h0 is not None:
        raise ValueError("the SSD kernel path starts from a zero state; "
                         "h0 must be None")
    return SSD.apply(x, dt, A, Bm, Cm, chunk)
