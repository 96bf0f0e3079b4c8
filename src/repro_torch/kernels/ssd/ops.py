"""SSD in the model's (B, S, H, P) layout over the flat-head kernel (forward
only; the autograd.Function whose backward recomputes through
``models.mamba2.ssd_chunked`` comes with the training slice)."""
from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_flat


def _to_flat(x, dt, A, Bm, Cm):
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    xf = x.permute(0, 2, 1, 3).reshape(B_ * H, S, P).contiguous()
    dtf = dt.permute(0, 2, 1).reshape(B_ * H, S).contiguous()
    Af = A[None, :].expand(B_, H).reshape(B_ * H).contiguous()
    Bf = Bm.permute(0, 2, 1, 3).reshape(B_ * H, S, N).contiguous()
    Cf = Cm.permute(0, 2, 1, 3).reshape(B_ * H, S, N).contiguous()
    return xf, dtf, Af, Bf, Cf


def ssd(x, dt, A, Bm, Cm, chunk: int = 128, h0=None):
    """Model layout: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,H,N).
    Returns (y, final state (B,H,N,P)). The kernel starts from a zero
    state, so ``h0`` must be None (prefill from scratch); decode carries
    the state through ``models.mamba2.ssd_decode_step``."""
    if h0 is not None:
        raise ValueError("the SSD kernel path starts from a zero state; "
                         "h0 must be None")
    B_, S, H, P = x.shape
    y, hT = ssd_flat(*_to_flat(x, dt, A, Bm, Cm), chunk=chunk)
    y = y.reshape(B_, H, S, P).permute(0, 2, 1, 3)
    return y, hT.reshape(B_, H, *hT.shape[1:])
