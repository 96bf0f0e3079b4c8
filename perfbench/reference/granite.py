"""Plain float32 Granite 4.0-H forward (``model_type`` granitemoehybrid:
IBM's ibm-granite/granite-4.0-h-small), from the configuration file's
sizes and weights drawn again from the seed, one layer at a time.

    h = E[tokens] * embedding_multiplier
    for each layer:
        h = h + residual_multiplier * Mixer(RMSNorm(h))
        u = RMSNorm(h);  h = h + residual_multiplier * (MoE(u) + Shared(u))
    logits = (RMSNorm(h) / logits_scaling) @ E^T          (tied head)

``layer_types`` names each layer's mixer. A Mamba-2 mixer: in_proj packed
as [z, x, B, C, dt], a causal depthwise conv (with its bias) and SiLU
over [x, B, C], dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD
(``reference/mamba2.py``'s chunked form, over the sequence padded with
zeros to whole chunks: a causal scan's outputs do not see positions past
them), the skip D x, then RMSNorm(y * silu(z)) and out_proj. An attention
mixer: GQA with no positional embedding, scores q k^T times
``attention_multiplier``, causal softmax. The MoE: router logits u W_r
in float32, the top ``num_experts_per_tok`` (ties to the lower expert),
their softmax as the gates, each chosen expert's SwiGLU; beside it one
shared SwiGLU MLP of width ``shared_intermediate_size``.

As the configuration file states, where a prefill holds more than
``moe_drop_above_tokens`` tokens (rows x prompt) its tokens are routed in
groups of ``moe_group_size`` consecutive positions of a row, an expert
taking at most ceil(group * top_k / experts * capacity_factor) of a
group's tokens in token order (later choices dropped); otherwise, and for
generated tokens, none is dropped. That is the only departure from the
published model.

The weights are the harness's draw (``harness/weights.py``), key by key,
but for three, each the harness's draw scaled (``scales``, and the program
is handed the same values):

- the tied token table, divided by ``embedding_multiplier``
  (``token_table``): the embeddings then enter the first layer at the
  harness's scale for every model, N(0, 0.02). At the undivided rule the
  scaled embeddings outweigh the 20 layers' sum in the residual stream,
  the tied head scores each position's input token far above every
  other, and every served token repeats its input, whatever the layers
  compute (a bf16, an fp8 or a faulty program alike);
- the Mamba-2 conv taps, times sqrt(channels), as the served Mamba-2 LM's
  (``reference/mamba2_serve.py``): without it the SSM state's term is
  third-order small and no logit shows whether a decode step wrote it;
- the attention's ``wq`` and ``wk``, each times sqrt(SCORE_STD /
  (attention_multiplier x sqrt(head dim))), so that the scores of inputs
  of unit RMS have a standard deviation of SCORE_STD, 3, and a query picks
  a few of 4096 keys. At the harness's rule they have 0.088 (the
  multiplier is 1/128, not 1/sqrt(128)): every query averages the whole
  context alike, and the attention's output does not depend on where a
  key stands (a rotary embedding applied by mistake moves nothing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.harness import weights
from perfbench.reference.mamba2 import rmsnorm, ssd
from perfbench.reference.mamba2_serve import conv_scale, scaled
from perfbench.reference.precision import Precision

SCORE_STD = 3.0


def mamba_dims(cfg: dict):
    """(d_inner, heads, head dim, groups, state, conv channels)."""
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    d_inner = cfg["mamba_expand"] * cfg["hidden_size"]
    if h * p != d_inner:
        raise ValueError(f"{h} heads x {p} != d_inner {d_inner}")
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return d_inner, h, p, g, n, d_inner + 2 * g * n


def layer_shapes(cfg: dict, layer: int) -> dict:
    d = cfg["hidden_size"]
    out = {"pre_norm/scale": (d,)}
    if cfg["layer_types"][layer] == "attention":
        h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = d // h
        out.update({"attn/wq/w": (d, h * hd), "attn/wk/w": (d, kv * hd),
                    "attn/wv/w": (d, kv * hd), "attn/wo/w": (h * hd, d)})
    else:
        d_inner, h, _, g, n, conv_dim = mamba_dims(cfg)
        out.update({"mamba/in_proj/w": (d, 2 * d_inner + 2 * g * n + h),
                    "mamba/conv_w": (cfg["mamba_d_conv"], conv_dim),
                    "mamba/conv_b": (conv_dim,),
                    "mamba/dt_bias": (h,), "mamba/A_log": (h,),
                    "mamba/D": (h,), "mamba/norm/scale": (d_inner,),
                    "mamba/out_proj/w": (d_inner, d)})
    e, f = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]
    out.update({"mlp_norm/scale": (d,), "moe/router": (d, e),
                "moe/w_gate": (e, d, f), "moe/w_up": (e, d, f),
                "moe/w_down": (e, f, d), "moe/shared/w_up/w": (d, fs),
                "moe/shared/w_down/w": (fs, d),
                "moe/shared/w_gate/w": (d, fs)})
    return out


def _draw(cfg, seed, key, shape, device):
    name = "router_dtype" if key.endswith("router") else "param_dtype"
    return weights.draw(key, shape, getattr(torch, cfg[name]), device,
                        seed).float()


def token_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """The tied token table in the parameter dtype: the harness's draw of
    ``embed/tok`` divided by ``embedding_multiplier`` in float32, then
    rounded to the parameter dtype (the program is handed these values)."""
    dtype = getattr(torch, cfg["param_dtype"])
    shape = (cfg["vocab_size"], cfg["hidden_size"])
    table = weights.draw("embed/tok", shape, dtype, device, seed)
    return (table.float() / cfg["embedding_multiplier"]).to(dtype)


def scales(cfg: dict) -> dict:
    """{a layer's weight name: the factor its harness draw is scaled by}."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    qk = math.sqrt(SCORE_STD / (cfg["attention_multiplier"] * math.sqrt(hd)))
    return {"mamba/conv_w": conv_scale(mamba_dims(cfg)[-1]),
            "attn/wq/w": qk, "attn/wk/w": qk}


def layer_params(cfg, seed, layer, device) -> dict:
    pdt = getattr(torch, cfg["param_dtype"])
    mult = scales(cfg)
    p = {}
    for k, s in layer_shapes(cfg, layer).items():
        w = _draw(cfg, seed, f"layers/{layer}/{k}", s, device)
        p[k] = scaled(w.to(pdt), mult[k]).float() if k in mult else w
    return p


def padded_ssd(x, a, bm, cm, chunk: int):
    """``ssd`` over the sequence padded with zeros to whole chunks (x and
    dt A zero there), cut back: the scan is causal, so no output reads a
    padded position."""
    s = x.shape[1]
    pad = -s % chunk if s > chunk else 0
    if pad:
        x, a, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in (x, a, bm, cm))
    return ssd(x, a, bm, cm, chunk)[:, :s]


def mamba(p, x, cfg, prec: Precision):
    d_inner, h, hp, g, n, conv_dim = mamba_dims(cfg)
    rows, s, _ = x.shape
    u = prec.mm(x, p["mamba/in_proj/w"])
    z, xbc, dtr = torch.split(u, [d_inner, conv_dim, h], dim=-1)
    k = cfg["mamba_d_conv"]
    xbc = F.conv1d(xbc.transpose(1, 2), p["mamba/conv_w"].t()[:, None, :],
                   p["mamba/conv_b"], padding=k - 1,
                   groups=conv_dim)[..., :s].transpose(1, 2)
    xs, bm, cm = torch.split(F.silu(xbc), [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dtr + p["mamba/dt_bias"])
    a = -torch.exp(p["mamba/A_log"])
    xs = xs.reshape(rows, s, h, hp)
    y = torch.empty_like(xs)
    for i in range(rows):       # one row at a time: the scan's tiles
        r = slice(i, i + 1)
        y[r] = padded_ssd(prec.act(xs[r]) * dt[r, ..., None], a * dt[r],
                          prec.act(bm[r].reshape(1, s, g, n)),
                          prec.act(cm[r].reshape(1, s, g, n)),
                          cfg["mamba_chunk_size"])
    y = (y + xs * p["mamba/D"][:, None]).reshape(rows, s, d_inner)
    y = rmsnorm(y * F.silu(z), p["mamba/norm/scale"], cfg["rms_norm_eps"])
    return prec.mm(y, p["mamba/out_proj/w"])


def attention(p, x, cfg, prec: Precision):
    rows, t, d = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, r = d // h, h // kv
    q = prec.mm(x, p["attn/wq/w"]).reshape(rows, t, kv, r, hd)
    k = prec.mm(x, p["attn/wk/w"]).reshape(rows, t, kv, hd)
    v = prec.mm(x, p["attn/wv/w"]).reshape(rows, t, kv, hd)
    hidden = torch.triu(torch.ones(t, t, dtype=torch.bool, device=x.device),
                        1)
    out = torch.empty((rows, t, kv, r, hd), dtype=torch.float32,
                      device=x.device)
    for i in range(rows):
        s = torch.einsum("tgrd,sgd->grts", prec.act(q[i]), prec.act(k[i])) \
            * cfg["attention_multiplier"]
        s.masked_fill_(hidden, float("-inf"))
        out[i] = torch.einsum("grts,sgd->tgrd", torch.softmax(s, dim=-1),
                              prec.act(v[i]))
        del s
    return prec.mm(out.reshape(rows, t, h * hd), p["attn/wo/w"])


def swiglu(x, w_gate, w_up, w_down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def _capacity(keep, gi, cfg, prompt: int):
    """Clear ``keep`` where a prompt token's choice lies past its expert's
    capacity in its group."""
    rows, _, k = gi.shape
    e, g = cfg["num_local_experts"], cfg["moe_group_size"]
    cap = math.ceil(g * k / e * cfg["moe_capacity_factor"])
    oh = (gi[:, :prompt, :, None] == torch.arange(e, device=gi.device)) \
        .float().reshape(rows, prompt // g, g, k, e)
    tok_e = oh.sum(3)
    before = (torch.cumsum(tok_e, dim=2) - tok_e)[:, :, :, None, :] \
        + torch.cumsum(oh, dim=3) - oh
    pos = (before * oh).sum(-1).reshape(rows, prompt, k)
    keep[:, :prompt] = pos < cap


def moe(p, x, cfg, prompt: int, prec: Precision, drop: bool):
    """The routed experts and the shared MLP, summed."""
    rows, t, d = x.shape
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    logits = x @ p["moe/router"]
    top, gi = torch.sort(logits, dim=-1, descending=True, stable=True)
    gw, gi = torch.softmax(top[..., :k], dim=-1), gi[..., :k]
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
    return y.reshape(rows, t, d) + swiglu(
        x, p["moe/shared/w_gate/w"], p["moe/shared/w_up/w"],
        p["moe/shared/w_down/w"], prec)


def block(p, x, cfg, layer, prompt, prec, drop):
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rmsnorm(x, p["pre_norm/scale"], eps)
    mixer = attention if cfg["layer_types"][layer] == "attention" else mamba
    x = x + rm * mixer(p, h, cfg, prec)
    u = rmsnorm(x, p["mlp_norm/scale"], eps)
    return x + rm * moe(p, u, cfg, prompt, prec, drop)


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs, prompt: int, read_from: int, device,
           prec: Precision, prefill_rows: int):
    """seqs (R, T) tokens, the first ``prompt`` of each row its prompt,
    which the program prefilled ``prefill_rows`` rows at a time. Returns
    the logits at positions read_from..T-1, (R, T - read_from, V)
    float32."""
    d = cfg["hidden_size"]
    table = token_table(cfg, seed, device).float()
    x = table[seqs] * cfg["embedding_multiplier"]
    drop = prefill_rows * prompt > cfg["moe_drop_above_tokens"]
    for layer in range(cfg["num_hidden_layers"]):
        p = layer_params(cfg, seed, layer, device)
        x = block(p, x, cfg, layer, prompt, prec, drop)
        del p
    x = rmsnorm(x[:, read_from:], _draw(cfg, seed, "final_norm/scale", (d,),
                                        device), cfg["rms_norm_eps"])
    return prec.mm(x / cfg["logits_scaling"], table.t())
