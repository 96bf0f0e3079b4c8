"""SSD in the model's layout over the kernel (forward only; the
autograd.Function whose backward recomputes through
``models.mamba2.ssd_chunked`` comes with the training slice)."""
from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_grouped


def ssd(x, dt, A, Bm, Cm, chunk: int = 128, h0=None):
    """Model layout: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) per
    group, G dividing H (per-head B and C are the case G = H). x and dt
    may be strided views; nothing is copied or broadcast. Returns (y
    (B,S,H,P), final state (B,H,N,P)). The kernel starts from a zero
    state, so ``h0`` must be None (prefill from scratch); decode carries
    the state through ``models.mamba2.ssd_decode_step``."""
    if h0 is not None:
        raise ValueError("the SSD kernel path starts from a zero state; "
                         "h0 must be None")
    return ssd_grouped(x, dt, A, Bm, Cm, chunk=chunk)
