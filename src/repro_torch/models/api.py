"""Unified model API dispatching by config family.

    init(gen, cfg)                 -> params on gen's device
    loss_fn(params, batch, cfg)    -> scalar
    forward(params, batch, cfg)    -> (logits, aux)
    prefill(params, batch, cfg)    -> (last logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

An encoder-decoder config (whisper) takes batches with ``frames`` (B,
S_enc, D) beside ``tokens``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whp


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encdec


def init(gen, cfg: ModelConfig):
    return whp.init(gen, cfg) if cfg.encdec else tfm.init(gen, cfg)


def loss_fn(params, batch: dict, cfg: ModelConfig):
    if cfg.encdec:
        return whp.loss_fn(params, batch, cfg)
    return tfm.loss_fn(params, batch, cfg)


def forward(params, batch: dict, cfg: ModelConfig):
    if cfg.encdec:
        return whp.forward(params, batch, cfg)
    return tfm.forward(params, batch["tokens"], cfg)


def prefill(params, batch: dict, cfg: ModelConfig, cap=None):
    if cfg.encdec:
        return whp.prefill(params, batch, cfg, cap=cap)
    return tfm.prefill(params, batch["tokens"], cfg, cap=cap)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    if cfg.encdec:
        return whp.decode_step(params, cache, tokens, pos, cfg)
    return tfm.decode_step(params, cache, tokens, pos, cfg)
