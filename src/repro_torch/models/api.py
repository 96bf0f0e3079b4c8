"""Unified model API dispatching by config family (decoder-only models;
the encoder-decoder family comes with the whisper slice).

    init(gen, cfg)                 -> params on gen's device
    loss_fn(params, batch, cfg)    -> scalar
    forward(params, batch, cfg)    -> (logits, aux)
    prefill(params, batch, cfg)    -> (last logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encdec


def _decoder_only(cfg: ModelConfig):
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP queue 1, slice 6: whisper)")


def init(gen, cfg: ModelConfig):
    _decoder_only(cfg)
    return tfm.init(gen, cfg)


def loss_fn(params, batch: dict, cfg: ModelConfig):
    _decoder_only(cfg)
    return tfm.loss_fn(params, batch, cfg)


def forward(params, batch: dict, cfg: ModelConfig):
    _decoder_only(cfg)
    return tfm.forward(params, batch["tokens"], cfg)


def prefill(params, batch: dict, cfg: ModelConfig, cap=None):
    _decoder_only(cfg)
    return tfm.prefill(params, batch["tokens"], cfg, cap=cap)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    _decoder_only(cfg)
    return tfm.decode_step(params, cache, tokens, pos, cfg)
