"""Model FLOPs of a prefill of a Mamba-2 LM (``model_type`` mamba2) or a
Granite 4.0-H hybrid (granitemoehybrid: Mamba-2 and NoPE GQA layers as
``layer_types`` names them, a MoE with a shared MLP in every layer), from
a configuration file's sizes: 2 N_active tokens plus the attention
(context S/2) or SSD-state term. A frozen copy of the arithmetic of
``repro_torch.launch.roofline``, as ``work.model_flops`` is for the
other configurations, so that no later change to the program moves the
numerator.
"""
from __future__ import annotations


def layer_kinds(cfg: dict) -> list:
    """[(mixer, ffn)] per layer."""
    n = cfg["num_hidden_layers"]
    if cfg["model_type"] == "mamba2":
        return [("mamba", "none")] * n
    if cfg["model_type"] != "granitemoehybrid":
        raise ValueError(cfg["model_type"])
    ffn = "moe" if cfg["num_local_experts"] else "dense"
    return [("attn" if t == "attention" else "mamba", ffn)
            for t in cfg["layer_types"][:n]]


def _mamba(cfg: dict):
    """(d_inner, heads, head dim, groups, state) of a Mamba-2 layer."""
    if cfg["model_type"] == "mamba2":
        p, g, n = cfg["head_dim"], cfg["n_groups"], cfg["state_size"]
        d_inner = cfg["expand"] * cfg["hidden_size"]
    else:
        p, g, n = (cfg["mamba_d_head"], cfg["mamba_n_groups"],
                   cfg["mamba_d_state"])
        d_inner = cfg["mamba_expand"] * cfg["hidden_size"]
    return d_inner, d_inner // p, p, g, n


def active_matmul_params(cfg: dict) -> float:
    """Parameters in matmuls a token flows through: the MoE's top-k
    experts and its shared MLP only, the embedding gather excluded, the
    LM head included."""
    d = cfg["hidden_size"]
    total = 0.0
    for mixer, ffn in layer_kinds(cfg):
        if mixer == "mamba":
            d_inner, heads, _, g, n = _mamba(cfg)
            total += d * (2 * d_inner + 2 * g * n + heads) + d_inner * d
        else:
            h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
            hd = d // h
            total += d * h * hd + 2 * d * kv * hd + h * hd * d
        if ffn == "moe":
            total += 3 * d * (cfg["intermediate_size"]
                              * cfg["num_experts_per_tok"]
                              + cfg["shared_intermediate_size"])
        elif ffn == "dense":
            total += 3 * d * cfg["intermediate_size"]
    return total + d * cfg["vocab_size"]


def attention_flops_per_token(cfg: dict, ctx: int) -> float:
    """Score and value flops a token at context ``ctx``; a Mamba layer's
    SSD state flops."""
    total = 0.0
    for mixer, _ in layer_kinds(cfg):
        if mixer == "mamba":
            _, heads, p, _, n = _mamba(cfg)
            total += 4 * heads * n * p
        else:
            h = cfg["num_attention_heads"]
            total += 2 * ctx * h * (cfg["hidden_size"] // h) * 2
    return total


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """One prefill of ``batch`` sequences of ``seq`` tokens."""
    tokens = batch * seq
    return (2.0 * active_matmul_params(cfg) * tokens
            + attention_flops_per_token(cfg, seq // 2) * tokens)
