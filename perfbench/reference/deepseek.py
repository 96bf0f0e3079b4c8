"""Plain float32 DeepSeek-V2-Lite forward (arXiv:2405.04434), from the
configuration file's sizes and weights drawn again from the seed, one
layer at a time.

A layer: x + MLA(RMSNorm(x)), then + FFN(RMSNorm(x)). MLA in its
materialised form: q = x Wq (no q compression), the latent c = RMSNorm(x
W_dkv[:r]) and a shared rope key k_r = RoPE(x W_dkv[r:]); per head k =
[c W_uk, k_r], v = c W_uv, causal softmax(q k^T / sqrt(d_nope + d_rope)),
out W_o. RoPE rotates halves (x1, x2) of the rope dims by position p
times theta^(-2i/d). The first ``first_k_dense_replace`` layers' FFN is
a SwiGLU MLP; the others route each token by a float32 softmax over the
routed experts, keep the top ``num_experts_per_tok`` (ties to the lower
expert), renormalise their gates, and add the shared experts' SwiGLU.

As the configuration file states, where a prefill holds more than
``moe_drop_above_tokens`` tokens (rows x prompt) its tokens are routed in
groups of ``moe_group_size`` consecutive positions of a row, an expert
taking at most ceil(group * top_k / experts * capacity_factor) of a
group's tokens in token order (later choices dropped); otherwise, and for
generated tokens, none is dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.harness import weights
from perfbench.reference.precision import Precision


def layer_shapes(cfg: dict, layer: int) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    out = {"pre_norm/scale": (d,), "attn/wq/w": (d, h * (dn + dr)),
           "attn/w_dkv/w": (d, r + dr), "attn/kv_norm/scale": (r,),
           "attn/w_uk/w": (r, h * dn), "attn/w_uv/w": (r, h * dv),
           "attn/wo/w": (h * dv, d), "mlp_norm/scale": (d,)}
    if layer < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        out.update({"mlp/w_up/w": (d, f), "mlp/w_down/w": (f, d),
                    "mlp/w_gate/w": (d, f)})
    else:
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        fs = f * cfg["n_shared_experts"]
        out.update({"moe/router": (d, e), "moe/w_gate": (e, d, f),
                    "moe/w_up": (e, d, f), "moe/w_down": (e, f, d),
                    "moe/shared/w_up/w": (d, fs),
                    "moe/shared/w_down/w": (fs, d),
                    "moe/shared/w_gate/w": (d, fs)})
    return out


def _draw(cfg, seed, key, shape, device):
    name = "router_dtype" if key.endswith("router") else "param_dtype"
    return weights.draw(key, shape, getattr(torch, cfg[name]), device,
                        seed).float()


def layer_params(cfg, seed, layer, device) -> dict:
    return {k: _draw(cfg, seed, f"layers/{layer}/{k}", s, device)
            for k, s in layer_shapes(cfg, layer).items()}


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (..., T, H, d) at positions 0..T-1."""
    d, t = x.shape[-1], x.shape[-3]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(p, x, cfg, prec: Precision):
    rows, t, _ = x.shape
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, theta = cfg["kv_lora_rank"], float(cfg["rope_theta"])
    q = prec.mm(x, p["attn/wq/w"]).reshape(rows, t, h, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    lat = prec.mm(x, p["attn/w_dkv/w"])
    c = rmsnorm(lat[..., :r], p["attn/kv_norm/scale"], cfg["rms_norm_eps"])
    kr = rope(lat[..., None, r:], theta)                  # (rows, t, 1, dr)
    kn = prec.mm(c, p["attn/w_uk/w"]).reshape(rows, t, h, dn)
    v = prec.mm(c, p["attn/w_uv/w"]).reshape(rows, t, h, dv)
    k = torch.cat([kn, kr.expand(rows, t, h, dr)], dim=-1)
    hidden = torch.triu(torch.ones(t, t, dtype=torch.bool, device=x.device),
                        1)
    out = torch.empty((rows, t, h, dv), dtype=torch.float32, device=x.device)
    for i in range(rows):
        s = torch.einsum("thd,shd->hts", prec.act(q[i]), prec.act(k[i])) \
            / math.sqrt(dn + dr)
        s.masked_fill_(hidden, float("-inf"))
        out[i] = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1),
                              prec.act(v[i]))
        del s
    return prec.mm(out.reshape(rows, t, h * dv), p["attn/wo/w"])


def swiglu(x, w_gate, w_up, w_down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def _capacity(keep, gi, cfg, prompt: int):
    """Clear ``keep`` where a prompt token's choice lies past its expert's
    capacity in its group."""
    rows, _, k = gi.shape
    e, g = cfg["n_routed_experts"], cfg["moe_group_size"]
    cap = math.ceil(g * k / e * cfg["moe_capacity_factor"])
    oh = (gi[:, :prompt, :, None] == torch.arange(e, device=gi.device)) \
        .float().reshape(rows, prompt // g, g, k, e)
    tok_e = oh.sum(3)
    before = (torch.cumsum(tok_e, dim=2) - tok_e)[:, :, :, None, :] \
        + torch.cumsum(oh, dim=3) - oh
    pos = (before * oh).sum(-1).reshape(rows, prompt, k)
    keep[:, :prompt] = pos < cap


def moe(p, x, cfg, prompt: int, prec: Precision, drop: bool):
    rows, t, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["moe/router"], dim=-1)
    gw, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, gi = gw[..., :k], gi[..., :k]
    gw = gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9)
    keep = torch.ones(gi.shape, dtype=torch.bool, device=x.device)
    if drop:
        _capacity(keep, gi, cfg, prompt)
    xf = x.reshape(-1, d)
    y = torch.zeros_like(xf)
    gi, gw, keep = gi.reshape(-1, k), gw.reshape(-1, k), keep.reshape(-1, k)
    for j in range(e):
        sel = (gi == j) & keep
        tok = sel.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        w = (gw * sel).sum(-1)[tok]
        out = swiglu(xf[tok], p["moe/w_gate"][j], p["moe/w_up"][j],
                     p["moe/w_down"][j], prec)
        y.index_add_(0, tok, out * w[:, None])
    y = y.reshape(rows, t, d)
    return y + swiglu(x, p["moe/shared/w_gate/w"], p["moe/shared/w_up/w"],
                      p["moe/shared/w_down/w"], prec)


def block(p, x, cfg, layer, prompt, prec, drop):
    eps = cfg["rms_norm_eps"]
    x = x + mla(p, rmsnorm(x, p["pre_norm/scale"], eps), cfg, prec)
    h = rmsnorm(x, p["mlp_norm/scale"], eps)
    if layer < cfg["first_k_dense_replace"]:
        f = swiglu(h, p["mlp/w_gate/w"], p["mlp/w_up/w"], p["mlp/w_down/w"],
                   prec)
    else:
        f = moe(p, h, cfg, prompt, prec, drop)
    return x + f


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs, prompt: int, read_from: int, device,
           prec: Precision, prefill_rows: int):
    """seqs (R, T) tokens, the first ``prompt`` of each row its prompt,
    which the program prefilled ``prefill_rows`` rows at a time. Returns
    the logits at positions read_from..T-1, (R, T - read_from, V)
    float32."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    table = _draw(cfg, seed, "embed/tok", (v, d), device)
    x = table[seqs]
    del table
    drop = prefill_rows * prompt > cfg["moe_drop_above_tokens"]
    for layer in range(cfg["num_hidden_layers"]):
        p = layer_params(cfg, seed, layer, device)
        x = block(p, x, cfg, layer, prompt, prec, drop)
        del p
    x = rmsnorm(x[:, read_from:], _draw(cfg, seed, "final_norm/scale", (d,),
                                        device), cfg["rms_norm_eps"])
    return prec.mm(x, _draw(cfg, seed, "head", (d, v), device))
