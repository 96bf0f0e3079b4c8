"""Plain PyTorch versions of the SSD kernel (flat per-head layout).

    x: (BH, S, P)  dt: (BH, S)  A: (BH,)  Bm, Cm: (BH, S, N)
Semantics: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ; y_t = C_t h_t.
``ssd_scan_ref`` is the exact sequential recurrence; ``ssd_chunked_ref``
is the block decomposition the kernel implements. Both start from a zero
state and return (y in x's dtype, hT (BH, N, P) float32).
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, Bm, Cm):
    BH, S, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((BH, N, P), dtype=f32, device=x.device)
    A = A.to(f32)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)
        a = torch.exp(dt_t * A)                                  # (BH,)
        u = torch.einsum("bn,bp,b->bnp", Bm[:, t].to(f32), x[:, t].to(f32),
                         dt_t)
        h = a[:, None, None] * h + u
        ys.append(torch.einsum("bn,bnp->bp", Cm[:, t].to(f32), h))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((BH, 0, P), dtype=f32)
    return y.to(x.dtype), h


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int = 64):
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    while S % Q:
        Q //= 2
    nc = S // Q
    f32 = torch.float32
    xc = x.reshape(BH, nc, Q, P).to(f32)
    dtc = dt.reshape(BH, nc, Q).to(f32)
    Bc = Bm.reshape(BH, nc, Q, N).to(f32)
    Cc = Cm.reshape(BH, nc, Q, N).to(f32)

    dA = dtc * A.to(f32)[:, None, None]
    cum = torch.cumsum(dA, dim=2)
    scores = torch.einsum("bnqd,bnkd->bnqk", Cc, Bc)
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # a select, not a 0/1 product: above the diagonal exp() may be inf
    decay = torch.where(tril, decay, torch.zeros((), dtype=f32,
                                                 device=x.device))
    M = scores * decay * dtc[..., None, :]
    y_diag = torch.einsum("bnqk,bnkp->bnqp", M, xc)

    sdecay = torch.exp(cum[:, :, -1:] - cum)
    Sc = torch.einsum("bnqd,bnq,bnqp->bndp", Bc, sdecay * dtc, xc)
    tot = torch.exp(cum[:, :, -1])

    h = torch.zeros((BH, N, P), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = tot[:, c, None, None] * h + Sc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (BH, nc, N, P)
    y_off = torch.einsum("bnqd,bndp,bnq->bnqp", Cc, h_prevs, torch.exp(cum))
    return (y_diag + y_off).reshape(BH, S, P).to(x.dtype), h


def ssd_grouped_ref(x, dt, A, Bm, Cm, chunk: int = 64):
    """``ssd_chunked_ref`` in the model layout: x (B, S, H, P), dt
    (B, S, H), A (H,), Bm and Cm (B, S, G, N) per group, head h reading
    group h // (H / G). Returns (y (B, S, H, P), hT (B, H, N, P))."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]

    def flat(t):                         # (B, S, H, W) -> (B*H, S, W)
        return t.permute(0, 2, 1, 3).reshape(B_ * H, S, t.shape[-1])

    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    y, h = ssd_chunked_ref(flat(x), dt.permute(0, 2, 1).reshape(B_ * H, S),
                           A.repeat(B_), flat(Bh), flat(Ch), chunk=chunk)
    return (y.reshape(B_, H, S, P).permute(0, 2, 1, 3),
            h.reshape(B_, H, N, P))
