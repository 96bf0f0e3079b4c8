"""Mamba-2 (state-space duality) block in PyTorch.

SSD semantics (Dao & Gu 2024): per head h with state size N, head dim P:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T
    y_t = C_t h_t + D * x_t
Three implementations:
  - ``scan``:     exact sequential recurrence (oracle, O(S) steps)
  - ``chunked``:  block decomposition (intra-chunk quadratic + inter-chunk
                  state passing), a Python loop over chunks, each chunk
                  checkpointed under autograd
  - ``pallas``:   the hand-written CUDA kernel (``kernels/ssd``); the name
                  is the reference's, so one config drives both packages

Traced, each call of the mixer (``mamba_apply``, ``mamba_decode_step``) is
the span ``mamba``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig, SSMCfg
from repro_torch.kernels.causal_conv.ref import (causal_conv,  # noqa: F401
                                                 causal_conv_silu_ref)
from repro_torch.kernels.gated_norm.ref import gated_norm_ref
from repro_torch.models.common import (Params, _normal, dense, dense_init,
                                       norm_init, pdtype)


# --------------------------------------------------------------------------
# SSD cores. x:(B,S,H,P) dt:(B,S,H) A:(H,) Bm,Cm:(B,S,H,N) (groups already
# broadcast to heads). Return y:(B,S,H,P) and final state (B,H,N,P) f32.
# The ``ssd`` dispatch takes Bm,Cm per group, (B,S,G,N).
# --------------------------------------------------------------------------

def ssd_scan(x, dt, A, Bm, Cm, h0=None):
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    h = h0 if h0 is not None else torch.zeros((B_, H, N, P),
                                              dtype=torch.float32,
                                              device=x.device)
    ys = []
    for t in range(S):
        y_t, h = ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y_t)
    return torch.stack(ys, dim=1), h


def _ssd_chunk(h, xc, dtc, Bc, Cc, A, mask, out_dtype):
    """One chunk of the block decomposition from the carried state h:
    returns (y (B,Q,H,P) in ``out_dtype``, the state after the chunk)."""
    f32 = torch.float32
    xc, dtc, Bc, Cc = xc.to(f32), dtc.to(f32), Bc.to(f32), Cc.to(f32)
    dA = dtc * A                            # (B,Q,H) <= 0
    cum = torch.cumsum(dA, dim=1)           # inclusive
    # intra-chunk quadratic term
    scores = torch.einsum("bqhd,bkhd->bhqk", Cc, Bc)
    ci = cum.movedim(2, 1)                  # (B,H,Q)
    # masked before the exp: above the diagonal the difference may exceed
    # exp's range, and exp(inf)'s gradient times the select's zero is NaN
    decay = torch.exp(torch.where(
        mask, ci[..., :, None] - ci[..., None, :],
        torch.full((), float("-inf"), dtype=f32, device=xc.device)))
    M = scores * decay * dtc.movedim(2, 1)[..., None, :]
    y = torch.einsum("bhqk,bkhp->bqhp", M, xc)
    # carried-state contribution
    y = y + torch.einsum("bqhd,bhdp,bqh->bqhp", Cc, h, torch.exp(cum))
    # state update
    sdecay = torch.exp(cum[:, -1:, :] - cum) * dtc
    Sc = torch.einsum("bqhd,bqh,bqhp->bhdp", Bc, sdecay, xc)
    h = torch.exp(cum[:, -1, :])[..., None, None] * h + Sc
    return y.to(out_dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, h0=None, chunk: int = 256):
    """Block-decomposed SSD, one chunk at a time (the reference's
    chunk rule: ``chunk`` halved until it divides S). Under autograd each
    chunk body is checkpointed, as the reference's ``jax.checkpoint`` of
    its scan body: the backward recomputes a chunk's (B,H,Q,Q) decay and
    score tiles from its inputs and carried state instead of keeping them
    for all S / Q chunks."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    while S % Q:
        Q //= 2
    f32 = torch.float32
    A = A.to(f32)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = h0 if h0 is not None else torch.zeros((B_, H, N, P), dtype=f32,
                                              device=x.device)
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0))
    ys = []
    for s0 in range(0, S, Q):
        args = (h, x[:, s0:s0 + Q], dt[:, s0:s0 + Q], Bm[:, s0:s0 + Q],
                Cm[:, s0:s0 + Q], A, mask, x.dtype)
        if remat:
            y, h = checkpoint(_ssd_chunk, *args, use_reentrant=False)
        else:
            y, h = _ssd_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One-token recurrence. x:(B,H,P) dt:(B,H) Bm,Cm:(B,H,N) h:(B,H,N,P)."""
    f32 = torch.float32
    dt = dt.to(f32)
    a = torch.exp(dt * A.to(f32))
    u = torch.einsum("bhn,bhp,bh->bhnp", Bm.to(f32), x.to(f32), dt)
    h = a[..., None, None] * h + u
    y = torch.einsum("bhn,bhnp->bhp", Cm.to(f32), h)
    return y.to(x.dtype), h


def ssd(x, dt, A, Bm, Cm, *, impl: str, chunk: int = 256, h0=None):
    """Bm, Cm: (B,S,G,N) per group, G dividing H. The kernel (``pallas``)
    reads them so; ``scan`` and ``chunked`` broadcast them to heads, as
    the reference does."""
    if impl == "pallas":
        from repro_torch.kernels.ssd import ops as ssd_ops
        return ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    H = x.shape[2]
    Bm, Cm = _broadcast_groups(Bm, H), _broadcast_groups(Cm, H)
    if impl == "scan":
        return ssd_scan(x, dt, A, Bm, Cm, h0)
    if impl == "chunked":
        return ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
    raise ValueError(impl)


# --------------------------------------------------------------------------
# causal depthwise conv1d (the full-sequence conv, ``causal_conv``, lives
# with its kernel's plain version in kernels/causal_conv/ref.py)
# --------------------------------------------------------------------------

def causal_conv_step(state, x_new, w, b):
    """state: (B,K-1,C), x_new: (B,C) -> (y (B,C), new state)."""
    window = torch.cat([state, x_new[:, None, :]], dim=1)       # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return y.to(x_new.dtype), window[:, 1:, :]


# --------------------------------------------------------------------------
# Mamba-2 block
# --------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    s: SSMCfg = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return d_inner, H, conv_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    s: SSMCfg = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_dim = mamba_dims(cfg)
    dt, dev = pdtype(cfg), gen.device
    # packed in_proj: [z, x, B, C, dt]
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.d_state + H
    in_proj = dense_init(gen, d, d_in_proj, dtype=dt)
    conv_w = _normal(gen, (s.d_conv, conv_dim),
                     1.0 / math.sqrt(s.d_conv * conv_dim), dt)
    out_proj = dense_init(gen, d_inner, d, dtype=dt,
                          scale=1.0 / math.sqrt(d_inner))
    # dt bias: inverse softplus of uniform [dt_min, dt_max] (log-spaced)
    u = torch.rand((H,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    A = 1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "dt_bias": dt_bias.to(dt),
        "A_log": torch.log(A).to(dt),
        "D": torch.ones((H,), dtype=dt, device=dev),
        "norm": norm_init(d_inner, "rmsnorm", dt, dev),
        "out_proj": out_proj,
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    """z, xBC (x, B and C side by side: the conv's input) and dt, column
    slices of the packed projection."""
    d_inner, H, conv_dim = mamba_dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)


def _broadcast_groups(t, H: int):
    """(B,S,G,N) -> (B,S,H,N) broadcasting groups over heads."""
    B_, S, G, N = t.shape
    return t[:, :, :, None, :].expand(B_, S, G, H // G, N).reshape(
        B_, S, H, N)


def _dt_A(dtr, p: Params):
    """dt = softplus(raw + bias) and A = -exp(A_log), both in f32."""
    dt = F.softplus(dtr.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def conv_silu(xbc, p: Params, cfg: ModelConfig):
    """The mixer's conv stage, silu(causal_conv(xBC)): xBC (B, S, conv_dim),
    read in place as in_proj's column slice. Through the hand-written
    kernel where the config takes the mixer's kernels (``ssd_impl``
    "pallas"; for CPU tensors that path computes the plain version), else
    the plain expression."""
    if cfg.ssd_impl == "pallas":
        from repro_torch.kernels.causal_conv import ops as cc_ops
        return cc_ops.causal_conv_silu(xbc, p["conv_w"], p["conv_b"])
    return causal_conv_silu_ref(xbc, p["conv_w"], p["conv_b"])


def gated_norm(y, x, z, p: Params, cfg: ModelConfig):
    """The mixer's output stage, rmsnorm((y + D x) silu(z)) scale: y, x
    (..., H, P) per head, z and the result (..., d_inner). Through the
    hand-written kernel where the config takes the mixer's kernels
    (``ssd_impl`` "pallas"; for CPU tensors that path computes the plain
    version), else the plain expression."""
    if cfg.ssd_impl == "pallas":
        from repro_torch.kernels.gated_norm import ops as gn_ops
        return gn_ops.gated_norm(y, x, z, p["D"], p["norm"]["scale"],
                                 cfg.norm_eps)
    return gated_norm_ref(y, x, z, p["D"], p["norm"]["scale"], cfg.norm_eps)


@telemetry.spanned("mamba")
def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Full-sequence mamba2 mixer. x: (B,S,D). With ``return_state`` also
    returns (conv state, final SSM state) for decode to continue from."""
    s: SSMCfg = cfg.ssm
    B_, S, _ = x.shape
    d_inner, H, conv_dim = mamba_dims(cfg)
    if return_state and S < s.d_conv - 1:
        raise ValueError(f"a prompt of {S} tokens is shorter than the "
                         f"{s.d_conv - 1} positions of the conv state")
    zxbcdt = dense(p["in_proj"], x)
    z, xbc_pre, dtr = _split_proj(zxbcdt, cfg)
    xbc = conv_silu(xbc_pre, p, cfg)
    xin, B_r, C_r = torch.split(
        xbc, [d_inner, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    xh = xin.reshape(B_, S, H, s.headdim)
    dt, A = _dt_A(dtr, p)
    gshape = (B_, S, s.ngroups, s.d_state)
    y, hT = ssd(xh, dt, A, B_r.reshape(gshape), C_r.reshape(gshape),
                impl=cfg.ssd_impl, chunk=s.chunk_size)
    y = gated_norm(y, xh, z, p, cfg)
    out = dense(p["out_proj"], y)
    if return_state:
        # the pre-conv, pre-SiLU window of the last d_conv - 1 positions:
        # a view into in_proj's output, which the caller copies into its
        # cache
        conv_state = xbc_pre[:, S - (s.d_conv - 1):, :]
        return out, (conv_state, hT)
    return out


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device="cpu",
                     lead: Tuple[int, ...] = ()) -> dict:
    """Zero decode cache; ``lead`` prepends axes (the stacked periods)."""
    s: SSMCfg = cfg.ssm
    _, H, conv_dim = mamba_dims(cfg)
    return {"conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, H, s.d_state, s.headdim),
                               dtype=torch.float32, device=device)}


@telemetry.spanned("mamba")
def mamba_decode_step(p: Params, x: torch.Tensor, cache: dict,
                      cfg: ModelConfig):
    """x: (B,1,D) -> (y (B,1,D), cache). Writes the new conv window and SSM
    state into ``cache`` in place (the reference returns new arrays), so
    a layer's view of the stacked cache stays current."""
    s: SSMCfg = cfg.ssm
    B_ = x.shape[0]
    d_inner, H, _ = mamba_dims(cfg)
    gn = s.ngroups * s.d_state
    z, xbc, dtr = _split_proj(dense(p["in_proj"], x[:, 0, :]), cfg)
    y_conv, conv_new = causal_conv_step(cache["conv"], xbc, p["conv_w"],
                                        p["conv_b"])
    xin, B_r, C_r = torch.split(F.silu(y_conv), [d_inner, gn, gn], dim=-1)
    xh = xin.reshape(B_, H, s.headdim)
    R = H // s.ngroups
    Bh = B_r.reshape(B_, s.ngroups, 1, s.d_state).expand(
        B_, s.ngroups, R, s.d_state).reshape(B_, H, s.d_state)
    Ch = C_r.reshape(B_, s.ngroups, 1, s.d_state).expand(
        B_, s.ngroups, R, s.d_state).reshape(B_, H, s.d_state)
    dt, A = _dt_A(dtr, p)
    y, h_new = ssd_decode_step(cache["ssm"], xh, dt, A, Bh, Ch)
    # the conv step's einsum hands its output over column-major; the
    # stage's kernel reads rows
    y = gated_norm(y, xh.contiguous(), z, p, cfg)
    out = dense(p["out_proj"], y)[:, None, :]
    cache["conv"].copy_(conv_new)
    cache["ssm"].copy_(h_new)
    return out, cache
