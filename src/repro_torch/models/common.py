"""Common model components in PyTorch: norms, rope, grouped attention
(naive / chunked / the hand-written flash kernel), GQA, MLA (DeepSeek-V2
multi-head latent attention), MLPs, the GShard-style MoE, embeddings.

Functional like the reference: ``*_init(gen, ...) -> params`` (nested dicts
of f32 tensors on the generator's device) and ``*_apply(params, x, ...) ->
y``. Compute runs in the config's compute dtype (bf16 by default); softmax
statistics in f32. The losses (``lm_head_loss``, the fused chunked
cross-entropy and ``cross_entropy``) train the split LMs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.configs.base import MLACfg, MoECfg, ModelConfig

Params = dict

NEG_INF = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype=torch.float32,
              device="cpu") -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:  # layernorm
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (NeoX half-rotation convention)
# --------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,) or broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (d/2,)
    angles = positions[..., :, None].float() * freqs      # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]              # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention cores (grouped-query layout throughout)
#   q: (B, Sq, G, R, D)   k, v: (B, Skv, G, D)
# where G = n_kv_heads, R = n_heads // n_kv_heads.
# --------------------------------------------------------------------------

def _soft_cap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def _mask_bias(qpos, kpos, *, causal: bool, window: int,
               kv_valid_len=None) -> torch.Tensor:
    """Additive f32 bias (Sq, Skv): 0 where allowed, NEG_INF elsewhere."""
    dq = qpos[:, None]
    dk = kpos[None, :]
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool,
                    device=kpos.device)
    if causal:
        ok &= dq >= dk
    if window > 0:
        ok &= (dq - dk) < window
    if kv_valid_len is not None:
        ok &= dk < kv_valid_len
    zero = torch.zeros((), dtype=torch.float32, device=kpos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    softcap: float = 0.0, q_offset=0,
                    kv_valid_len=None) -> torch.Tensor:
    """Reference full-materialization attention. Grouped layout."""
    B, Sq, G, R, D = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * scale
    s = _soft_cap(s, softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    s = s + _mask_bias(qpos, kpos, causal=causal, window=window,
                       kv_valid_len=kv_valid_len)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.to(q.dtype)


def _largest_divisor(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _tile_visible(q_lo: int, q_hi: int, k_lo: int, k_hi: int, *,
                  causal: bool, window: int) -> bool:
    """Whether any (q, k) pair of the tile [q_lo, q_hi] x [k_lo, k_hi]
    (absolute positions, inclusive) passes the causal and window masks.
    A tile that fails contributes exactly nothing (its probabilities are
    exp(-1e30 - lse) = 0, and a fully masked leading tile's sums are wiped
    by the next tile's rescale alpha = 0), so skipping it changes no
    result."""
    if causal and q_hi < k_lo:
        return False
    return window <= 0 or q_lo - k_hi < window


def _flash_fwd_impl(q, k, v, causal, window, softcap, q_offset, q_chunk,
                    kv_chunk):
    """Online-softmax forward over (q_chunk, kv_chunk) tiles. Returns
    (out, lse) with lse: (B, G, R, Sq) f32."""
    B, Sq, G, R, D = q.shape
    Skv = k.shape[1]
    q_chunk = _largest_divisor(Sq, q_chunk)
    kv_chunk = _largest_divisor(Skv, kv_chunk)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].float()
        qpos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, G, R, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, R, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_chunk, G, R, D), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, kv_chunk):
            if not _tile_visible(q_offset + q0, q_offset + q0 + q_chunk - 1,
                                 k0, k0 + kv_chunk - 1, causal=causal,
                                 window=window):
                continue
            kc = k[:, k0:k0 + kv_chunk].float()
            vc = v[:, k0:k0 + kv_chunk].float()
            s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kc) * scale
            s = _soft_cap(s, softcap)
            kpos = k0 + torch.arange(kv_chunk, device=dev)
            s = s + _mask_bias(qpos, kpos, causal=causal, window=window)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p, vc)
            acc = acc * torch.movedim(alpha, 3, 1)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        lses.append(m + torch.log(l))
        outs.append((acc / torch.movedim(l, 3, 1)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=3)


def _flash_bwd(q, k, v, out, lse, g, causal, window, softcap, q_offset,
               q_chunk, kv_chunk):
    """The flash-attention gradient: each tile's exact softmax is
    recomputed from (q, k, lse), so memory stays O(q_chunk * kv_chunk).
    Returns (dq, dk, dv) in the input dtypes; dk and dv are summed over
    each kv head's R query heads."""
    B, Sq, G, R, D = q.shape
    Skv = k.shape[1]
    q_chunk = _largest_divisor(Sq, q_chunk)
    kv_chunk = _largest_divisor(Skv, kv_chunk)
    scale = 1.0 / math.sqrt(D)
    f32, dev = torch.float32, q.device
    # delta_i = sum_d dO_i * O_i   (B,G,R,Sq)
    delta = torch.einsum("bqgrd,bqgrd->bgrq", g.float(), out.float())
    dq = torch.empty((B, Sq, G, R, D), dtype=f32, device=dev)
    dk = torch.zeros((B, Skv, G, D), dtype=f32, device=dev)
    dv = torch.zeros((B, Skv, G, D), dtype=f32, device=dev)
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].float()
        gc = g[:, q0:q0 + q_chunk].float()
        lse_c = lse[..., q0:q0 + q_chunk, None]
        delta_c = delta[..., q0:q0 + q_chunk, None]
        qpos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        dq_c = torch.zeros((B, q_chunk, G, R, D), dtype=f32, device=dev)
        for k0 in range(0, Skv, kv_chunk):
            if not _tile_visible(q_offset + q0, q_offset + q0 + q_chunk - 1,
                                 k0, k0 + kv_chunk - 1, causal=causal,
                                 window=window):
                continue
            kc = k[:, k0:k0 + kv_chunk].float()
            vc = v[:, k0:k0 + kv_chunk].float()
            s_pre = torch.einsum("bqgrd,bkgd->bgrqk", qc, kc) * scale
            s = _soft_cap(s_pre, softcap)
            kpos = k0 + torch.arange(kv_chunk, device=dev)
            bias = _mask_bias(qpos, kpos, causal=causal, window=window)
            p = torch.exp(s + bias - lse_c)           # exact softmax tile
            dp = torch.einsum("bqgrd,bkgd->bgrqk", gc, vc)
            ds = p * (dp - delta_c)
            if softcap > 0:
                ds = ds * (1.0 - torch.square(torch.tanh(s_pre / softcap)))
            dq_c = dq_c + torch.einsum("bgrqk,bkgd->bqgrd", ds, kc) * scale
            dk[:, k0:k0 + kv_chunk] += torch.einsum(
                "bgrqk,bqgrd->bkgd", ds, qc) * scale
            dv[:, k0:k0 + kv_chunk] += torch.einsum(
                "bgrqk,bqgrd->bkgd", p, gc)
        dq[:, q0:q0 + q_chunk] = dq_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, q_chunk,
                kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, softcap,
                                   q_offset, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g, *ctx.args)
        return (dq, dk, dv) + (None,) * 6


def chunked_attention(q, k, v, causal=True, window=0, softcap=0.0,
                      q_offset=0, q_chunk=512, kv_chunk=1024
                      ) -> torch.Tensor:
    """Flash attention in plain torch with a flash backward (the
    reference's ``custom_vjp``): the forward keeps only (out, lse), and the
    backward recomputes each (q_chunk, kv_chunk) probability tile, so no
    O(Sq * Skv) residual is stashed. Tiles that the masks hide entirely
    are skipped. Also the backward of the flash kernel's
    ``autograd.Function``."""
    return _ChunkedAttention.apply(q, k, v, causal, window, softcap,
                                   q_offset, q_chunk, kv_chunk)


def grouped_attention(q, k, v, cfg: ModelConfig, *, causal: bool,
                      window: int = 0, q_offset=0, kv_valid_len=None,
                      impl: Optional[str] = None) -> torch.Tensor:
    impl = impl or cfg.attn_impl
    # chunked and the kernel take a static q_offset; tensor offsets only
    # occur on decode/cache paths, which use naive anyway.
    fast_ok = (kv_valid_len is None and q.shape[1] > 1
               and isinstance(q_offset, int))
    if impl == "chunked" and fast_ok:
        return chunked_attention(q, k, v, causal, window, cfg.attn_softcap,
                                 q_offset, cfg.q_chunk, cfg.kv_chunk)
    if impl == "pallas" and fast_ok:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal, window,
                                      cfg.attn_softcap, q_offset)
    return naive_attention(q, k, v, causal=causal, window=window,
                           softcap=cfg.attn_softcap, q_offset=q_offset,
                           kv_valid_len=kv_valid_len)


# --------------------------------------------------------------------------
# GQA attention module
# --------------------------------------------------------------------------

def gqa_init(gen, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.n_heads, cfg.n_kv_heads
    dt = pdtype(cfg)
    p = {
        "wq": dense_init(gen, d, H * hd, bias=cfg.qkv_bias, dtype=dt),
        "wk": dense_init(gen, d, G * hd, bias=cfg.qkv_bias, dtype=dt),
        "wv": dense_init(gen, d, G * hd, bias=cfg.qkv_bias, dtype=dt),
        "wo": dense_init(gen, H * hd, d, dtype=dt,
                         scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dt, gen.device)
        p["k_norm"] = norm_init(hd, "rmsnorm", dt, gen.device)
    return p


def gqa_project_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, use_rope: bool = True):
    """Project and rope k/v for caching. x: (B, S, D) -> k, v: (B, S, G, hd)."""
    B, S, _ = x.shape
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    k = dense(p["wk"], x).reshape(B, S, G, hd)
    v = dense(p["wv"], x).reshape(B, S, G, hd)
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], k, "rmsnorm", cfg.norm_eps)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_valid_len=None, use_rope: bool = True,
              impl: Optional[str] = None) -> torch.Tensor:
    """Self- or cross-attention. If ``kv`` is given it is the (already
    roped/projected) key/value source (cache, the prefill's own k/v or
    encoder memory); with no ``positions`` the queries sit at 0..S-1."""
    B, S, _ = x.shape
    hd, H, G = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    R = H // G
    start = 0 if positions is None else None
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = dense(p["wq"], x).reshape(B, S, G, R, hd)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
    if use_rope:
        q = apply_rope(q.reshape(B, S, G * R, hd), positions,
                       cfg.rope_theta).reshape(B, S, G, R, hd)
    if kv is None:
        k, v = gqa_project_kv(p, x, cfg, positions, use_rope=use_rope)
        q_offset = 0
    else:
        k, v = kv
        # only causal/window masking consults absolute positions
        q_offset = ((positions[0] if start is None else start)
                    if (causal or window > 0) and positions.dim() == 1
                    else 0)
    o = grouped_attention(q, k, v, cfg, causal=causal, window=window,
                          q_offset=q_offset, kv_valid_len=kv_valid_len,
                          impl=impl)
    return dense(p["wo"], o.reshape(B, S, H * hd))


# --------------------------------------------------------------------------
# MLA attention (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig) -> Params:
    m: MLACfg = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dt = pdtype(cfg)
    qdim = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return {
        # q projection (V2-Lite: full rank)
        "wq": dense_init(gen, d, qdim, dtype=dt),
        # compressed kv latent + decoupled rope key
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype=dt),
        "kv_norm": norm_init(m.kv_lora_rank, "rmsnorm", dt, gen.device),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype=dt),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype=dt),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype=dt),
    }


def mla_project_latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor):
    """The cacheable latent: c_kv (B,S,r), normed, and the roped k_rope
    (B,S,dr)."""
    m: MLACfg = cfg.mla
    c_kv, k_rope = torch.split(dense(p["w_dkv"], x),
                               [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = apply_norm(p["kv_norm"], c_kv, "rmsnorm", cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, positions: Optional[torch.Tensor] = None,
              latent: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_valid_len=None, absorbed: bool = False) -> torch.Tensor:
    """MLA attention. ``latent`` is the (c_kv, k_rope) cache for decode,
    or the prefill's own latent (then, with no ``positions``, the queries
    sit at 0..S-1).

    Materialised (prefill): k = [k_nope, k_rope broadcast over heads] and v
    padded to the qk width dn + dr run through ``grouped_attention`` as H
    kv heads of one query head each (the flash kernel at head dim dn + dr
    when ``attn_impl`` selects it). Absorbed (decode): W_UK folded into
    the query and W_UV into the output, so scores and values touch only
    the rank-r latent; naive attention, no kernel, as in the reference.
    """
    m: MLACfg = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim, m.kv_lora_rank)
    start = 0 if positions is None else None
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = dense(p["wq"], x).reshape(B, S, H, dn + dr)
    q_nope, q_rope = torch.split(q, [dn, dr], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    if latent is None:
        c_kv, k_rope = mla_project_latent(p, x, cfg, positions)
        q_offset = 0
    else:
        c_kv, k_rope = latent
        q_offset = ((positions[0] if start is None else start)
                    if positions.dim() == 1 else 0)
    Skv = c_kv.shape[1]

    if absorbed:
        w_uk = p["w_uk"]["w"].reshape(r, H, dn).to(q_nope.dtype)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        qq = torch.cat([q_lat, q_rope], dim=-1)             # (B,S,H,r+dr)
        kk = torch.cat([c_kv, k_rope], dim=-1)              # (B,Skv,r+dr)
        # one kv head of width r+dr, value c_kv (r)
        qq = qq.reshape(B, S, 1, H, r + dr) / math.sqrt((dn + dr) / (r + dr))
        o_lat = naive_attention(qq, kk[:, :, None, :], c_kv[:, :, None, :],
                                causal=causal, q_offset=q_offset,
                                kv_valid_len=kv_valid_len)  # (B,S,1,H,r)
        w_uv = p["w_uv"]["w"].reshape(r, H, dv).to(x.dtype)
        o = torch.einsum("bshr,rhd->bshd", o_lat[:, :, 0], w_uv)
    else:
        k_nope = dense(p["w_uk"], c_kv).reshape(B, Skv, H, dn)
        v = dense(p["w_uv"], c_kv).reshape(B, Skv, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Skv, H, dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = grouped_attention(qq.reshape(B, S, H, 1, dn + dr), k,
                              F.pad(v, (0, dn + dr - dv)), cfg,
                              causal=causal, q_offset=q_offset,
                              kv_valid_len=kv_valid_len)
        o = o.reshape(B, S, H, dn + dr)[..., :dv]
    return dense(p["wo"], o.reshape(B, S, H * dv))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_init(gen, d: int, d_ff: int, cfg: ModelConfig, *,
             bias: bool = False) -> Params:
    dt = pdtype(cfg)
    p = {"w_up": dense_init(gen, d, d_ff, bias=bias, dtype=dt),
         "w_down": dense_init(gen, d_ff, d, bias=bias, dtype=dt)}
    if cfg.glu:
        p["w_gate"] = dense_init(gen, d, d_ff, bias=bias, dtype=dt)
    return p


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = dense(p["w_up"], x)
    if cfg.glu:
        h = _act(dense(p["w_gate"], x), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return dense(p["w_down"], h)


# --------------------------------------------------------------------------
# GShard-style MoE with grouped dense dispatch
# --------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig) -> Params:
    m: MoECfg = cfg.moe
    d, dff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    dt = pdtype(cfg)
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dff)
    p = {
        "router": _normal(gen, (d, E), s_in, torch.float32),
        "w_gate": _normal(gen, (E, d, dff), s_in, dt),
        "w_up": _normal(gen, (E, d, dff), s_in, dt),
        "w_down": _normal(gen, (E, dff, d), s_ff, dt),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(gen, d, dff * m.n_shared_experts, cfg)
    return p


def moe_route(p: Params, x: torch.Tensor, top_k: int):
    """The router: f32 softmax over the experts, the top-k, and the gates
    renormalised over the k choices. x: (..., D) -> (probs (..., E),
    gate_w (..., k), gate_idx (..., k)). Equal probabilities are taken
    lower expert first, as ``lax.top_k`` takes them (a stable sort:
    ``torch.topk`` leaves the order of ties open)."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[..., :top_k], gate_idx[..., :top_k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n).float()`` for indices in [0, n), as one
    comparison: the same values and the same ops on every device
    (``F.one_hot`` reads the indices' range back to the host on the CPU,
    scatters on CUDA and compares on ``meta``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


@telemetry.spanned("moe")
def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Grouped dense dispatch, as the
    reference: tokens split into groups of ``group_size`` (the largest
    divisor of B*S not above it); each group routes its tokens into (E, C)
    capacity slots through one-hot dispatch/combine einsums, a slot
    position counted in token order, then in choice order; choices past
    capacity C are dropped (``no_drop``: C = g*k, so none can be). The
    aux loss is Switch's E * sum_e(f_e * p_e) * ``router_aux_weight``.
    Traced, a call is the span ``moe`` with the counters ``moe.choices``
    (B*S*k) and ``moe.kept`` (the choices given a slot; with ``no_drop``
    all of them, counted with no device work)."""
    m: MoECfg = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    g = _largest_divisor(T, m.group_size)
    n = T // g
    xg = x.reshape(n, g, D)

    probs, gate_w, gate_idx = moe_route(p, xg, k)           # (n, g, k)
    C = g * k if no_drop else int(math.ceil(g * k / E * m.capacity_factor))
    oh = _one_hot(gate_idx, E)                              # (n, g, k, E)
    tok_e = oh.sum(2)                                       # (n, g, E)
    pos_base = torch.cumsum(tok_e, dim=1) - tok_e           # tokens before t
    within = torch.cumsum(oh, dim=2) - oh                   # earlier choices
    pos = ((pos_base[:, :, None, :] + within) * oh).sum(-1)   # (n, g, k)
    keep = pos < C
    if telemetry.tracing():
        telemetry.count("moe.choices", T * k)
        telemetry.count("moe.kept", T * k if no_drop else keep.sum())
    pos_oh = _one_hot(torch.where(keep, pos.long(), 0), C) \
        * keep[..., None]                                   # (n, g, k, C)
    disp = torch.einsum("ngke,ngkc->ngec", oh, pos_oh)
    comb = torch.einsum("ngke,ngkc->ngec", oh * gate_w[..., None], pos_oh)

    xe = torch.einsum("ngec,ngd->necd", disp.to(x.dtype), xg)   # (n,E,C,D)
    h = _act(torch.einsum("necd,edf->necf", xe, p["w_gate"].to(x.dtype)),
             cfg.act)
    h = h * torch.einsum("necd,edf->necf", xe, p["w_up"].to(x.dtype))
    ye = torch.einsum("necf,efd->necd", h, p["w_down"].to(x.dtype))
    y = torch.einsum("ngec,necd->ngd", comb.to(x.dtype), ye)

    f_e = tok_e.mean(dim=(0, 1)) / k                        # fraction routed
    p_e = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e) * m.router_aux_weight

    y = y.reshape(B, S, D)
    if m.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux


def moe_apply_naive(p: Params, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every expert on every token, no capacity drops. For tests on
    tiny shapes only."""
    m: MoECfg = cfg.moe
    _, gate_w, gate_idx = moe_route(p, x, m.top_k)
    h = _act(torch.einsum("bsd,edf->bsef", x, p["w_gate"].to(x.dtype)),
             cfg.act)
    h = h * torch.einsum("bsd,edf->bsef", x, p["w_up"].to(x.dtype))
    ye = torch.einsum("bsef,efd->bsed", h, p["w_down"].to(x.dtype))
    sel = _one_hot(gate_idx, m.n_experts)
    w = torch.einsum("bske,bsk->bse", sel, gate_w).to(x.dtype)
    y = torch.einsum("bse,bsed->bsd", w, ye)
    if m.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y


# --------------------------------------------------------------------------
# embeddings / heads
# --------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig) -> Params:
    dt = pdtype(cfg)
    p = {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                            1.0 / math.sqrt(cfg.d_model), dt)
    return p


def embed_apply(p: Params, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    x = p["tok"][tokens].to(cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def logits_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["head"].to(x.dtype)
    logits = logits.float()
    if cfg.final_softcap > 0:
        logits = _soft_cap(logits, cfg.final_softcap)
    return logits



# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def lm_head_loss(head_w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Cross-entropy from final hiddens. head_w: (D, V). With
    ``cfg.loss_chunk`` > 0 dividing S (and below it) the loss runs over
    token chunks along the sequence with a hand-written backward
    (``_FusedCE``), so peak memory is one chunk's logits, never the full
    (tokens, vocab) f32 logits."""
    D = x.shape[-1]
    B, S = tuple(labels.shape[:2]) if labels.dim() == 2 else \
        (1, labels.shape[0])
    x = x.reshape(B, S, D)
    labels = labels.reshape(B, S).long()
    mask = mask.reshape(B, S) if mask is not None else None
    chunk = cfg.loss_chunk
    if chunk <= 0 or S % max(chunk, 1) or S <= chunk:
        logits = (x @ head_w.to(x.dtype)).float()
        if cfg.final_softcap > 0:
            logits = _soft_cap(logits, cfg.final_softcap)
        return cross_entropy(logits, labels, mask)
    mask = mask if mask is not None else torch.ones(
        (B, S), dtype=torch.float32, device=x.device)
    return _FusedCE.apply(x, head_w, labels, mask, S // chunk,
                          float(cfg.final_softcap))


def _ce_chunk_stats(xc, head_w, lc, softcap: float):
    """One chunk's (logits, raw logits, lse, label logit), f32."""
    logits = (xc @ head_w.to(xc.dtype)).float()
    raw = logits
    if softcap > 0:
        logits = _soft_cap(logits, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None])[..., 0]
    return logits, raw, lse, ll


class _FusedCE(torch.autograd.Function):
    """Chunked cross-entropy with a hand-written backward: each chunk's
    softmax is recomputed, dlogits = p - onehot, and dW accumulates in one
    f32 (D, V) buffer; autograd through the chunk loop would keep every
    chunk's logits alive."""

    @staticmethod
    def forward(ctx, x, head_w, labels, mask, n: int, softcap: float):
        B, S, D = x.shape
        chunk = S // n
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            mc = mask[:, sl].float()
            _, _, lse, ll = _ce_chunk_stats(x[:, sl], head_w, labels[:, sl],
                                            softcap)
            tot = tot + ((lse - ll) * mc).sum()
            cnt = cnt + mc.sum()
        cnt = torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(x, head_w, labels, mask, cnt)
        ctx.n, ctx.softcap = n, softcap
        return tot / cnt

    @staticmethod
    def backward(ctx, g):
        x, head_w, labels, mask, cnt = ctx.saved_tensors
        n, softcap = ctx.n, ctx.softcap
        B, S, D = x.shape
        chunk = S // n
        scale = g / cnt
        w32 = head_w.float()
        dW = torch.zeros(tuple(head_w.shape), dtype=torch.float32,
                         device=x.device)
        dx = torch.empty_like(x)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            xc, lc = x[:, sl], labels[:, sl]
            logits, raw, lse, _ = _ce_chunk_stats(xc, head_w, lc, softcap)
            # in place: at a 256k vocab every (B, chunk, V) f32 temporary
            # is GBs
            dlogits = torch.exp(logits - lse[..., None])
            del logits
            dlogits.scatter_add_(-1, lc[..., None],
                                 torch.full_like(lse[..., None], -1.0))
            dlogits.mul_((mask[:, sl].float() * scale)[..., None])
            if softcap > 0:
                # 1 - tanh(raw / softcap)^2
                dlogits.mul_(torch.tanh(raw / softcap).square_().neg_()
                             .add_(1.0))
            del raw
            dx[:, sl] = (dlogits @ w32.T).to(x.dtype)
            dW += torch.einsum("bcd,bcv->dv", xc.float(), dlogits)
        return dx, dW.to(head_w.dtype), None, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) f32, labels (...) int."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
