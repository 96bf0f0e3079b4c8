"""Architecture registry: ``--arch <id>`` lookup, input specs per shape
cell, and reduced configs for CPU tests.

The 4 shape cells (``configs.base.SHAPES``):
    train_4k:    seq 4096,   global_batch 256  -> CPSL train step
    prefill_32k: seq 32768,  global_batch 32   -> prefill
    decode_32k:  seq 32768,  global_batch 128  -> one decode step
    long_500k:   seq 524288, global_batch 1    -> one decode step; only
                 for the sub-quadratic archs (mamba2, jamba).

``ARCHS`` are the reference's ten (``list_archs`` names them, so parity
tests compare exactly what the reference has); ``PORT_ARCHS`` the port's
own (``list_port_archs``). ``get`` finds either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite_16b,
                                 gemma2_2b, granite_4_0_h_small,
                                 jamba_v01_52b, mamba2_2p7b, phi35_moe_42b,
                                 qwen2_05b, qwen25_14b, qwen3_32b,
                                 whisper_small)
from repro_torch.configs.base import MLACfg, ModelConfig, ShapeCfg

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

# architectures the port serves that the reference has no config for
PORT_ARCHS = {
    "granite-4.0-h-small": granite_4_0_h_small.config,
}


def get(name: str) -> ModelConfig:
    make = ARCHS.get(name) or PORT_ARCHS.get(name)
    if make is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return make()


def list_archs():
    """The reference's architectures."""
    return sorted(ARCHS)


def list_port_archs():
    """The port's own architectures, beside ``list_archs``."""
    return sorted(PORT_ARCHS)


# archs eligible for the long_500k cell (sub-quadratic sequence mixing)
LONG_CTX_ARCHS = {"mamba2-2.7b", "jamba-v0.1-52b"}


def cells(arch: str):
    """Shape cells applicable to this arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CTX_ARCHS:
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    """The input batch of a shape cell as ``meta`` tensors (shapes and
    dtypes, no storage): tokens and labels for train, tokens for prefill
    (plus frames for enc-dec), one token column for decode."""
    gb, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    frames = ({"frames": meta((gb, cfg.enc_seq, cfg.d_model),
                              getattr(torch, cfg.dtype))}
              if cfg.encdec else {})
    if shape.kind == "train":
        return {"tokens": meta((gb, S)), "labels": meta((gb, S)), **frames}
    if shape.kind == "prefill":
        return {"tokens": meta((gb, S)), **frames}
    return {"tokens": meta((gb,))}


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
        if cfg.moe.d_ff_shared:
            # a shared MLP of its own width (granite): kept wider than one
            # expert, over 8 experts
            kw["moe"] = dataclasses.replace(kw["moe"], n_experts=8,
                                            d_ff_shared=48)
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


def concrete_batch(gen: torch.Generator, cfg: ModelConfig, *, batch: int,
                   seq: int) -> Dict:
    """A small random int32 batch on ``gen``'s device, drawn from
    ``gen``."""
    dev = gen.device
    out = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=dev,
                                dtype=torch.int32),
        "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=dev,
                                dtype=torch.int32),
    }
    if cfg.encdec:
        out["frames"] = torch.randn(
            (batch, cfg.enc_seq, cfg.d_model), generator=gen, device=dev
        ).to(getattr(torch, cfg.dtype))
    return out
