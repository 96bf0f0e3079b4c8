"""Batched serving engine: prefill + greedy/temperature decode with a KV
cache, over a fixed batch of requests (rows finishing early keep decoding
into padding, as in the reference)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, cap: int = 2048,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg, self.params, self.cap = cfg, params, cap

    @torch.inference_mode()
    def prefill(self, batch):
        return api.prefill(self.params, self._to_device(batch), self.cfg,
                           cap=self.cap)

    @torch.inference_mode()
    def decode(self, cache, tokens, pos: int):
        return api.decode_step(self.params, cache, tokens.to(self.device),
                               pos, self.cfg)

    def generate(self, batch, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """batch: {"tokens": (B, S_prompt)}, and for an enc-dec model
        {"tokens", "frames": (B, S_enc, D)}. Returns (B, steps) generated
        tokens (int32)."""
        logits, cache = self.prefill(batch)
        S = batch["tokens"].shape[1]
        outs = [self._sample(logits, temperature, generator)]
        for i in range(steps - 1):
            logits, cache = self.decode(cache, outs[-1], S + i)
            outs.append(self._sample(logits, temperature, generator))
        return torch.stack(outs, dim=1)

    def _to_device(self, batch):
        return {k: v.to(self.device) for k, v in batch.items()}

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0 or generator is None:
            # first maximum on ties, as jnp.argmax
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
