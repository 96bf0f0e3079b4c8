"""Roofline terms of a dry-run cell on one H100 (the port of
``repro.launch.roofline``).

Per (arch x shape) cell, from the dry run's op count:

    compute term    = FLOPs / (cards * 989e12)                [bf16 peak]
    memory term     = HBM bytes / (cards * 3.35e12)           [HBM3]
    collective term = collective bytes / (cards * 900e9)      [NVLink; 0
                                                               on one card]

FLOPs and bytes come from ``launch.hlo_analysis``, which counts the
step's aten ops as they run (the reference parses the compiled HLO);
MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (prefill) /
2*N_active*B (decode) is the "useful work" yardstick — the ratio
MODEL_FLOPS / HLO_FLOPs exposes remat recompute, causal-mask overcompute
and MoE dispatch overhead.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


def active_matmul_params(cfg: ModelConfig) -> float:
    """Parameters in matmuls a token flows through (MoE: top-k + shared
    experts only; embedding gather excluded; LM head included)."""
    d = cfg.d_model
    total = 0.0
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            hd = cfg.resolved_head_dim
            if cfg.attn_kind == "mla":
                m = cfg.mla
                total += (d * cfg.n_heads * (m.qk_nope_head_dim
                                             + m.qk_rope_head_dim)
                          + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                          + m.kv_lora_rank * cfg.n_heads
                          * (m.qk_nope_head_dim + m.v_head_dim)
                          + cfg.n_heads * m.v_head_dim * d)
            else:
                total += (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                          + cfg.n_heads * hd * d)
        else:
            s = cfg.ssm
            d_inner = s.expand * d
            H = d_inner // s.headdim
            total += d * (2 * d_inner + 2 * s.ngroups * s.d_state + H) \
                + d_inner * d
        if spec.ffn == "dense":
            total += (3 if cfg.glu else 2) * d * cfg.d_ff
        elif spec.ffn == "moe":
            m = cfg.moe
            total += (3 if cfg.glu else 2) * d * m.d_ff_expert \
                * (m.top_k + m.n_shared_experts)
    total += d * cfg.vocab_size        # LM head
    if cfg.encdec:
        # decoder cross-attn already counted via layer_specs? enc-dec
        # specs cover n_layers entries; cross-attn adds ~1 more attn block
        # per decoder layer.
        hd = cfg.resolved_head_dim
        n_dec = cfg.n_layers - cfg.n_enc_layers
        total += n_dec * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                          + cfg.n_heads * hd * d)
    return total


def attention_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Score+PV flops per generated/processed token at context ctx."""
    total = 0.0
    for spec in cfg.layer_specs():
        if spec.mixer != "attn":
            # SSD state flops per token
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            H = d_inner // s.headdim
            total += 4 * H * s.d_state * s.headdim
            continue
        eff = min(ctx, spec.window) if spec.window else ctx
        if cfg.attn_kind == "mla":
            m = cfg.mla
            total += 2 * eff * cfg.n_heads * (m.qk_nope_head_dim
                                              + m.qk_rope_head_dim
                                              + m.v_head_dim)
        else:
            total += 2 * eff * cfg.n_heads * cfg.resolved_head_dim * 2
    return total


def model_flops(cfg: ModelConfig, shape: ShapeCfg) -> float:
    N = active_matmul_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # causal average context = S/2
        attn = attention_flops_per_token(cfg, shape.seq_len // 2) * tokens
        return 6.0 * N * tokens + 3.0 * attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        attn = attention_flops_per_token(cfg, shape.seq_len // 2) * tokens
        return 2.0 * N * tokens + attn
    # decode: one token per sequence
    attn = attention_flops_per_token(cfg, shape.seq_len) * shape.global_batch
    return 2.0 * N * shape.global_batch + attn


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    bottleneck: str

    def to_dict(self):
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s,
                    model_flops=self.model_flops,
                    hlo_flops_global=self.hlo_flops_global,
                    useful_ratio=self.useful_ratio,
                    bottleneck=self.bottleneck)


def roofline_terms(parsed: dict, n_devices: int, cfg: ModelConfig,
                   shape: ShapeCfg) -> Roofline:
    flops_g = parsed["parsed_flops_per_device"] * n_devices
    bytes_g = parsed["parsed_hbm_bytes_per_device"] * n_devices
    coll_g = parsed["collective_bytes_per_device"] * n_devices
    compute_s = flops_g / (n_devices * PEAK_FLOPS_BF16)
    memory_s = bytes_g / (n_devices * HBM_BW)
    coll_s = coll_g / (n_devices * ICI_BW)
    mf = model_flops(cfg, shape)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(compute_s, memory_s, coll_s, mf, flops_g,
                    mf / max(flops_g, 1.0), bottleneck)
