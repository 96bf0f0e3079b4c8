"""Analytic per-layer cost profiles feeding the latency model / Alg. 2.

For each architecture we compute, per flattened layer index v (cut AFTER
layer v, v in {1..V}):
    xi_d(v):  bits of the device-side model (embed + layers[:v])
    xi_s(v):  bits of smashed data per *sample*
    xi_g(v):  bits of smashed-data gradient (paper convention: per batch)
    gamma_dF/dB(v): device FLOPs per sample (fwd / bwd)
    gamma_sF/sB(v): server FLOPs per sample

LM "sample" = one sequence of ``seq`` tokens; LeNet sample = one image.
BWD ~= 2x FWD (standard); the paper itself assumes FP == BP workloads
(Table II) — ``bp_ratio`` controls this (paper mode uses 1.0).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.latency import CutProfile
from repro_torch.models import lenet as ln


PARAM_BITS = 32   # paper quantizes to 32-bit


# --------------------------------------------------------------------------
# LM architectures
# --------------------------------------------------------------------------

def _attn_layer_costs(cfg: ModelConfig, spec: LayerSpec, seq: int):
    """(params, fwd flops per sample) for one attention mixer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.n_heads, cfg.n_kv_heads
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qdim = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        params = (d * qdim + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                  + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                  + H * m.v_head_dim * d)
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn_flops = 2 * seq * seq * H * (qk_dim + m.v_head_dim)
    else:
        params = d * H * hd + 2 * d * G * hd + H * hd * d
        attn_flops = 2 * seq * seq * H * hd * 2
        if spec.window:
            w = min(spec.window, seq)
            attn_flops = 2 * seq * w * H * hd * 2
    proj_flops = 2 * seq * params
    return params, proj_flops + attn_flops


def _mamba_layer_costs(cfg: ModelConfig, seq: int):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.d_state + H
    params = (d * d_in_proj + s.d_conv * conv_dim + conv_dim + 2 * H
              + d_inner + d_inner * d)
    proj = 2 * seq * (d * d_in_proj + d_inner * d)
    conv = 2 * seq * s.d_conv * conv_dim
    # SSD: intra-chunk (Q-blocked quadratic) + state update, ~= attn with
    # window Q plus state flops 2*S*H*N*P
    Q = s.chunk_size
    ssd = 2 * seq * Q * H * s.headdim + 4 * seq * H * s.d_state * s.headdim
    return params, proj + conv + ssd


def _ffn_layer_costs(cfg: ModelConfig, spec: LayerSpec, seq: int):
    d = cfg.d_model
    if spec.ffn == "none":
        return 0, 0
    if spec.ffn == "moe":
        m = cfg.moe
        n_mats = 3 if cfg.glu else 2
        params = d * m.n_experts + n_mats * m.n_experts * d * m.d_ff_expert
        active = n_mats * (m.top_k + m.n_shared_experts) * d * m.d_ff_expert
        return params, 2 * seq * active
    n_mats = 3 if cfg.glu else 2
    params = n_mats * d * cfg.d_ff
    return params, 2 * seq * params


def lm_profile(cfg: ModelConfig, seq: int, bp_ratio: float = 2.0,
               act_bits: int = 16) -> CutProfile:
    """Profile over cut layers v in {1..n_layers(-enc for encdec)}."""
    d = cfg.d_model
    specs = cfg.layer_specs()
    if cfg.encdec:
        specs = specs[:cfg.n_enc_layers]   # split lives in the encoder
        seq_dev = cfg.enc_seq
    else:
        seq_dev = seq

    embed_params = cfg.vocab_size * d
    per_layer_params, per_layer_flops = [], []
    for spec in specs:
        ap, af = (_attn_layer_costs(cfg, spec, seq_dev)
                  if spec.mixer == "attn"
                  else _mamba_layer_costs(cfg, seq_dev))
        fp, ff = _ffn_layer_costs(cfg, spec, seq_dev)
        per_layer_params.append(ap + fp + 2 * d)   # + norms
        per_layer_flops.append(af + ff)

    total_params = embed_params + sum(per_layer_params) + d \
        + (0 if cfg.tie_embeddings else d * cfg.vocab_size)
    total_flops = sum(per_layer_flops) + 2 * seq * d * cfg.vocab_size
    if cfg.encdec:
        # decoder-side server work (self+cross attn etc.), approximated by
        # re-running the cost model on the decoder stack
        dec_specs = cfg.layer_specs()[cfg.n_enc_layers:]
        for spec in dec_specs:
            ap, af = _attn_layer_costs(cfg, spec, seq)
            fp, ff = _ffn_layer_costs(cfg, spec, seq)
            total_params += ap + fp + 2 * d
            total_flops += af + ff + 2 * seq * _attn_layer_costs(
                cfg, spec, cfg.enc_seq)[0] // 2  # cross-attn ~ half proj

    V = len(specs)
    xi_d = np.zeros(V)
    xi_s = np.zeros(V)
    g_dF = np.zeros(V)
    cum_p, cum_f = embed_params, 2 * seq_dev * 0
    for v in range(1, V + 1):
        cum_p += per_layer_params[v - 1]
        cum_f += per_layer_flops[v - 1]
        xi_d[v - 1] = cum_p * PARAM_BITS
        xi_s[v - 1] = seq_dev * d * act_bits     # activations at the cut
        g_dF[v - 1] = cum_f
    g_sF = total_flops - g_dF
    xi_g = xi_s.copy()                           # same tensor size
    return CutProfile(name=cfg.name, xi_d=xi_d, xi_s=xi_s, xi_g=xi_g,
                      gamma_dF=g_dF, gamma_dB=bp_ratio * g_dF,
                      gamma_sF=np.maximum(g_sF, 0.0),
                      gamma_sB=bp_ratio * np.maximum(g_sF, 0.0))


# --------------------------------------------------------------------------
# LeNet (paper's model)
# --------------------------------------------------------------------------

def lenet_profile(input_hw: int = 28, bp_ratio: float = 1.0,
                  act_bits: int = 32) -> CutProfile:
    """Profile from the Table III model. bp_ratio=1.0 matches the paper's
    'FP and BP workloads are the same' assumption."""
    shapes = ln.layer_shapes(input_hw)
    h, c = input_hw, 1
    params, flops = [], []
    flat = None
    for i, name in enumerate(ln.LAYERS):
        out = shapes[i]
        if name.startswith("CONV"):
            cin, cout, pad = ln._CONV[name]
            p = 9 * cin * cout + cout
            oh = out[0]
            f = 2 * 9 * cin * cout * oh * oh
        elif name.startswith("POOL"):
            p = 0
            f = out[0] * out[1] * out[2] * 4
        else:
            if flat is None:
                flat = int(np.prod(shapes[i - 1]))
            fout = ln._FC[name]
            p = flat * fout + fout
            f = 2 * flat * fout
            flat = fout
        params.append(p)
        flops.append(f)

    V = len(ln.LAYERS)
    xi_d = np.cumsum(params) * float(PARAM_BITS)
    xi_s = np.array([float(np.prod(s)) * act_bits for s in shapes])
    g_dF = np.cumsum(flops).astype(float)
    g_sF = g_dF[-1] - g_dF
    return CutProfile(name="lenet", xi_d=xi_d, xi_s=xi_s, xi_g=xi_s.copy(),
                      gamma_dF=g_dF, gamma_dB=bp_ratio * g_dF,
                      gamma_sF=g_sF, gamma_sB=bp_ratio * g_sF)


def paper_constants_profile() -> CutProfile:
    """Table II / Fig. 1(b) constants as a 2-cut profile:
      v=1: POOL1 (xi_d=0.67 MB, xi_s=18 KB, gamma_d=5.6 MF, gamma_s=86.01 MF)
      v=2 == V: full model on device (FL degenerate case; 16.49 MB model,
                whole-model 91.61 MF per sample).
    Used to reproduce the paper's §VIII-B numbers exactly."""
    MB = 8 * 1024 * 1024
    KB = 8 * 1024
    return CutProfile(
        name="paper-tableII",
        xi_d=np.array([0.67 * MB, 16.49 * MB]),
        xi_s=np.array([18.0 * KB, 0.04 * KB]),
        xi_g=np.array([9.0 * KB * 16, 0.04 * KB]),  # text: 9 KB/sample, B=16
        gamma_dF=np.array([5.6e6, 91.61e6]),
        gamma_dB=np.array([5.6e6, 91.61e6]),
        gamma_sF=np.array([86.01e6, 0.0]),
        gamma_sB=np.array([86.01e6, 0.0]),
    )


def profile_for(cfg_or_name, seq: int = 4096, **kw) -> CutProfile:
    """The cut profile of ``"lenet"``, ``"paper"`` (the paper's constants)
    or an LM arch (an id or a ``ModelConfig``) at ``seq`` tokens."""
    if isinstance(cfg_or_name, str):
        if cfg_or_name == "lenet":
            return lenet_profile(**kw)
        if cfg_or_name == "paper":
            return paper_constants_profile()
        from repro_torch.configs import registry
        cfg_or_name = registry.get(cfg_or_name)
    if cfg_or_name.family == "cnn":
        return lenet_profile(**kw)
    return lm_profile(cfg_or_name, seq, **kw)
