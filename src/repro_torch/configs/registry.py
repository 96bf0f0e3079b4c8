"""Architecture registry: ``--arch <id>`` lookup and reduced configs for
CPU tests (``input_specs`` and ``concrete_batch`` come with the training
slice)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite_16b,
                                 gemma2_2b, jamba_v01_52b, mamba2_2p7b,
                                 phi35_moe_42b, qwen2_05b, qwen25_14b,
                                 qwen3_32b, whisper_small)
from repro_torch.configs.base import MLACfg, ModelConfig

ARCHS = {
    "whisper-small": whisper_small.config,
    "chameleon-34b": chameleon_34b.config,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.config,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.config,
    "mamba2-2.7b": mamba2_2p7b.config,
    "jamba-v0.1-52b": jamba_v01_52b.config,
    "gemma2-2b": gemma2_2b.config,
    "qwen2.5-14b": qwen25_14b.config,
    "qwen3-32b": qwen3_32b.config,
    "qwen2-0.5b": qwen2_05b.config,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]()


def list_archs():
    return sorted(ARCHS)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family/features, tiny dims: runs on the CPU in tests."""
    kw = dict(
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=211,
        n_layers=len(cfg.prologue) + 2 * len(cfg.pattern),
        remat=False,
        q_chunk=8, kv_chunk=8,
    )
    if cfg.moe is not None:
        # ample capacity: smoke tests check exact equivalences (no drops)
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        d_ff_expert=32, group_size=16,
                                        capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, q_lora_rank=0,
                           qk_nope_head_dim=16, qk_rope_head_dim=8,
                           v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=16,
                                        chunk_size=8)
    if cfg.encdec:
        kw["n_enc_layers"] = 2
        kw["n_layers"] = 4
        kw["enc_seq"] = 24
    return cfg.replace(**kw)
