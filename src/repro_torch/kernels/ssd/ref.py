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


def ssd_bwd_ref(x, dt, A, Bm, Cm, gy, ghT=None, chunk: int = 64):
    """The SSD backward as the kernel (``csrc/ssd_bwd.cu``) decomposes it,
    in plain f32, model layout: x and gy (B, S, H, P), dt (B, S, H), A
    (H,), Bm and Cm (B, S, G, N) per group, ghT (B, H, N, P) or None;
    ``chunk`` is the forward's chunk (``kernel.chunk_len``'s result).
    Returns (dx, ddt, dA, dB, dC) in f32, dB and dC summed over each
    group's heads.

    Per chunk of ``bwd.bwd_chunk`` rows (zero rows pad the last; their dt is 0,
    so the cumsum stays at its last value): the state entering each chunk
    h_k (h_{k+1} = T_k h_k + U_k) and the gradient of the state leaving it
    Dh_k (Dh_{k-1} = T_k Dh_k + V_k, Dh_last = ghT), then the chunk's
    terms through the masked scores, h_k and Dh_k, and a reverse cumsum
    of the cumsum's gradient into ddt and dA."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]
    # the kernel's chunk rule; imported here, not at the top, because the
    # kernel modules import this one
    from repro_torch.kernels.ssd.bwd import bwd_chunk
    f32 = torch.float32
    Qc = bwd_chunk(S, chunk)
    nc = -(-S // Qc)
    pad = nc * Qc - S

    def heads(t, w):          # (B, S, G or H, w) -> (B, H, nc, Qc, w)
        t = t.to(f32)
        if t.shape[2] != H:
            t = t.repeat_interleave(H // t.shape[2], dim=2)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.permute(0, 2, 1, 3).reshape(B_, H, nc, Qc, w)

    xc, gc, Bc, Cc = heads(x, P), heads(gy, P), heads(Bm, N), heads(Cm, N)
    dtc = heads(dt[..., None], 1)[..., 0]                 # (B, H, nc, Qc)
    cum = torch.cumsum(dtc * A.to(f32)[:, None, None], dim=-1)
    cl = cum[..., -1]
    tril = torch.tril(torch.ones((Qc, Qc), dtype=torch.bool,
                                 device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]           # cum_i - cum_j
    L = torch.exp(torch.where(tril, diff, torch.full(
        (), float("-inf"), dtype=f32, device=x.device)))
    Sc = Cc @ Bc.transpose(-1, -2)                         # (.., i, j)
    dM = gc @ xc.transpose(-1, -2)
    dtj = dtc[..., None, :]
    M = Sc * L * dtj
    dS = dM * L * dtj
    Rm = dM * Sc * L
    f = torch.exp(cl[..., None] - cum)
    w = f * dtc
    e = torch.exp(cum)
    U = torch.einsum("...jn,...j,...jp->...np", Bc, w, xc)
    V = torch.einsum("...in,...i,...ip->...np", Cc, e, gc)
    T = torch.exp(cl)
    hs, Dh = [], [None] * nc
    h = torch.zeros((B_, H, N, P), dtype=f32, device=x.device)
    for k in range(nc):
        hs.append(h)
        h = T[..., k, None, None] * h + U[:, :, k]
    d = (ghT.to(f32) if ghT is not None
         else torch.zeros((B_, H, N, P), dtype=f32, device=x.device))
    for k in reversed(range(nc)):
        Dh[k] = d
        d = T[..., k, None, None] * d + V[:, :, k]
    hs, Dh = torch.stack(hs, dim=2), torch.stack(Dh, dim=2)
    dT = T * (Dh * hs).sum((-2, -1))
    xB = Bc @ Dh                                           # B_j Dh: (j, P)
    dw = (xc * xB).sum(-1)
    dx = M.transpose(-1, -2) @ gc + w[..., None] * xB
    dB = dS.transpose(-1, -2) @ Cc + w[..., None] * (xc @ Dh.transpose(
        -1, -2))
    gh = gc @ hs.transpose(-1, -2)                         # h gy_i: (i, N)
    dC = dS @ Bc + e[..., None] * gh
    ddt = Rm.sum(-2) + f * dw
    # dM M enters dcum by rows and by columns; its diagonal's two shares
    # cancel, so both sums leave it out
    below = torch.tril(Rm * dtj, diagonal=-1)
    dcum = below.sum(-1) - below.sum(-2) - w * dw + e * (Cc * gh).sum(-1)
    dcum[..., -1] += (w * dw).sum(-1) + dT
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + A.to(f32)[:, None, None] * da
    dA = (dtc * da).sum((0, 2, 3))

    def back(t):              # (B, H, nc, Qc, w) -> (B, S, H, w)
        return t.reshape(B_, H, nc * Qc, -1)[:, :, :S].permute(0, 2, 1, 3)

    def groups(t):            # (B, S, H, w) -> (B, S, G, w)
        return t.reshape(B_, S, G, H // G, -1).sum(3)

    return (back(dx), back(ddt[..., None])[..., 0], dA, groups(back(dB)),
            groups(back(dC)))
