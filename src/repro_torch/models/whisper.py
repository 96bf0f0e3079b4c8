"""Whisper-small backbone (enc-dec transformer); the port of
``repro.models.whisper``.

The audio frontend (log-mel + 2x conv) is a stub, as in the reference:
callers pass precomputed frame embeddings (B, S_enc, D). LayerNorm
everywhere, absolute sinusoidal positions (no rope), GELU MLPs with bias.

The encoder's self-attention is non-causal; the decoder's is causal, and
its cross-attention reads the encoder output (``memory``). Both run
through ``common.grouped_attention``, so ``attn_impl="pallas"`` sends the
encoder, the decoder's self-attention and its cross-attention (Sq != Skv)
through the flash kernel; decode steps (one query) attend naively, as in
the reference.

The block stacks carry a leading layer axis (``enc_stack``, ``dec_stack``:
the reference's vmapped init), unbound once per pass. ``encode`` and
``decode_hidden`` checkpoint each block when ``cfg.remat``. The decode
cache is ``{"k", "v", "mk", "mv"}``, each stacked over the decoder layers:
the self-attention k/v written in place at each step, the cross-attention
k/v projected once at prefill.

CPSL split point: the encoder stack (the device holds the microphone);
device-side = frames + enc blocks[:v], server-side = enc blocks[v:] + the
full decoder + head (``core.splitting.make_encdec_split``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import Params
from repro_torch.models.transformer import _remat, _stack, head_matrix


def _inv_freq(d: int, device) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))


def sinusoid_pos(S: int, d: int, device="cpu") -> torch.Tensor:
    """(S, d) f32: sin over the first d/2 columns, cos over the rest."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_pos_at(pos: int, d: int, device="cpu") -> torch.Tensor:
    """(d,) f32: row ``pos`` of ``sinusoid_pos``."""
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen, cfg: ModelConfig) -> Params:
    dt, dev = cm.pdtype(cfg), gen.device
    return {
        "pre_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "attn": cm.gqa_init(gen, cfg),
        "mlp_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, bias=True),
    }


def _dec_block_init(gen, cfg: ModelConfig) -> Params:
    dt, dev = cm.pdtype(cfg), gen.device
    return {
        "pre_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "attn": cm.gqa_init(gen, cfg),
        "x_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "x_attn": cm.gqa_init(gen, cfg),
        "mlp_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, bias=True),
    }


def enc_block_apply(p: Params, x, cfg: ModelConfig):
    h = cm.apply_norm(p["pre_norm"], x, "layernorm", cfg.norm_eps)
    x = x + cm.gqa_apply(p["attn"], h, cfg, causal=False, use_rope=False)
    h = cm.apply_norm(p["mlp_norm"], x, "layernorm", cfg.norm_eps)
    return x + cm.mlp_apply(p["mlp"], h, cfg)


def dec_block_apply(p: Params, x, memory, cfg: ModelConfig, positions,
                    mem_kv=None, kv_valid_len=None, self_kv=None,
                    causal=None):
    """Self-attention over ``self_kv`` (the block's own k/v when None),
    causal by default exactly when ``self_kv`` is None (a prefill passes
    its own k/v, ``causal=True`` and no ``positions``), then
    cross-attention over ``mem_kv``, projected from ``memory`` when not
    given, then the MLP."""
    h = cm.apply_norm(p["pre_norm"], x, "layernorm", cfg.norm_eps)
    causal = self_kv is None if causal is None else causal
    x = x + cm.gqa_apply(p["attn"], h, cfg, causal=causal,
                         use_rope=False, positions=positions, kv=self_kv,
                         kv_valid_len=kv_valid_len)
    h = cm.apply_norm(p["x_norm"], x, "layernorm", cfg.norm_eps)
    if mem_kv is None:
        mem_kv = cm.gqa_project_kv(
            p["x_attn"], memory, cfg,
            torch.arange(memory.shape[1], device=memory.device),
            use_rope=False)
    x = x + cm.gqa_apply(p["x_attn"], h, cfg, causal=False, use_rope=False,
                         positions=positions, kv=mem_kv)
    h = cm.apply_norm(p["mlp_norm"], x, "layernorm", cfg.norm_eps)
    return x + cm.mlp_apply(p["mlp"], h, cfg)


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``gen``'s device, drawn from ``gen``."""
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers - cfg.n_enc_layers
    dt, dev = cm.pdtype(cfg), gen.device
    return {
        "embed": cm.embed_init(gen, cfg),
        "enc_stack": _stack([_enc_block_init(gen, cfg)
                             for _ in range(n_enc)]),
        "enc_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        "dec_stack": _stack([_dec_block_init(gen, cfg)
                             for _ in range(n_dec)]),
        "dec_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
    }


def embed_frames(frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Frames in the compute dtype plus their sinusoidal positions."""
    x = frames.to(cm.cdtype(cfg))
    return x + sinusoid_pos(x.shape[1], cfg.d_model, x.device).to(x.dtype)


def enc_blocks(stack: Params, x, cfg: ModelConfig, remat: bool = False):
    """The encoder blocks of ``stack`` (layer-stacked leaves) over x, each
    checkpointed with ``remat``."""
    blk = _remat(enc_block_apply) if remat else enc_block_apply
    for p in tree.unbind(stack):
        x = blk(p, x, cfg)
    return x


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           start_layer: int = 0, end_layer: Optional[int] = None):
    """frames: (B, S_enc, D) precomputed embeddings (frontend stub); or,
    with ``start_layer`` > 0, the hidden state entering that layer."""
    x = (embed_frames(frames, cfg) if start_layer == 0
         else frames.to(cm.cdtype(cfg)))
    n_enc = cfg.n_enc_layers
    end_layer = n_enc if end_layer is None else end_layer
    sl = tree.map(lambda t: t[start_layer:end_layer], params["enc_stack"])
    x = enc_blocks(sl, x, cfg, remat=cfg.remat)
    if end_layer == n_enc:
        x = cm.apply_norm(params["enc_norm"], x, "layernorm", cfg.norm_eps)
    return x


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    x = cm.embed_apply(params["embed"], tokens, cfg)
    return x + sinusoid_pos(tokens.shape[1], cfg.d_model,
                            x.device).to(x.dtype)


def decode_hidden(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig):
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_tokens(params, tokens, cfg)
    blk = _remat(dec_block_apply) if cfg.remat else dec_block_apply
    for p in tree.unbind(params["dec_stack"]):
        x = blk(p, x, memory, cfg, positions)
    return cm.apply_norm(params["dec_norm"], x, "layernorm", cfg.norm_eps)


def decode(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
           cfg: ModelConfig):
    x = decode_hidden(params, tokens, memory, cfg)
    return cm.logits_apply(params["embed"], x, cfg)


def forward(params: Params, batch: dict, cfg: ModelConfig):
    """batch: {"frames", "tokens"} -> (logits (B, S, V) f32, aux = 0)."""
    memory = encode(params, batch["frames"], cfg)
    logits = decode(params, batch["tokens"], memory, cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean token cross-entropy of ``batch["labels"]`` (masked by
    ``batch["mask"]`` when given)."""
    memory = encode(params, batch["frames"], cfg)
    x = decode_hidden(params, batch["tokens"], memory, cfg)
    return cm.lm_head_loss(head_matrix(params, cfg), x, batch["labels"], cfg,
                           batch.get("mask"))


# -- serving ---------------------------------------------------------------

def prefill(params: Params, batch: dict, cfg: ModelConfig,
            cap: Optional[int] = None):
    """Encode the frames and prefill the decoder's self-attention caches
    with ``tokens``. Returns (last logits (B, V), cache); the
    cross-attention k/v are projected once here."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = cap or S
    if S > cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache of {cap}")
    dev = tokens.device
    memory = encode(params, batch["frames"], cfg)
    n_dec = cfg.n_layers - cfg.n_enc_layers
    G, hd, dt = cfg.n_kv_heads, cfg.resolved_head_dim, cm.cdtype(cfg)
    cache = {
        "k": torch.zeros((n_dec, B, cap, G, hd), dtype=dt, device=dev),
        "v": torch.zeros((n_dec, B, cap, G, hd), dtype=dt, device=dev),
        "mk": torch.empty((n_dec,) + memory.shape[:2] + (G, hd), dtype=dt,
                          device=dev),
        "mv": torch.empty((n_dec,) + memory.shape[:2] + (G, hd), dtype=dt,
                          device=dev),
    }
    positions = torch.arange(S, device=dev)
    mem_pos = torch.arange(memory.shape[1], device=dev)
    x = _embed_tokens(params, tokens, cfg)
    for n, p in enumerate(tree.unbind(params["dec_stack"])):
        h = cm.apply_norm(p["pre_norm"], x, "layernorm", cfg.norm_eps)
        k, v = cm.gqa_project_kv(p["attn"], h, cfg, positions, use_rope=False)
        cache["k"][n, :, :S] = k.to(dt)
        cache["v"][n, :, :S] = v.to(dt)
        mk, mv = cm.gqa_project_kv(p["x_attn"], memory, cfg, mem_pos,
                                   use_rope=False)
        cache["mk"][n] = mk.to(dt)
        cache["mv"][n] = mv.to(dt)
        x = dec_block_apply(p, x, memory, cfg, None,
                            mem_kv=(cache["mk"][n], cache["mv"][n]),
                            self_kv=(k, v), causal=True)
    x = cm.apply_norm(params["dec_norm"], x, "layernorm", cfg.norm_eps)
    logits = cm.logits_apply(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0], cache


def decode_step(params: Params, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """tokens: (B,) -> (logits (B, V), cache). Writes the new token's
    self-attention k/v into ``cache`` in place."""
    cap = cache["k"].shape[2]
    if not 0 <= pos < cap:
        raise IndexError(f"decode position {pos} outside cache of {cap}")
    x = cm.embed_apply(params["embed"], tokens[:, None], cfg)
    x = x + sinusoid_pos_at(pos, cfg.d_model, x.device).to(x.dtype)
    positions = torch.full((1,), pos, device=x.device)
    for n, p in enumerate(tree.unbind(params["dec_stack"])):
        kc, vc = cache["k"][n], cache["v"][n]
        h = cm.apply_norm(p["pre_norm"], x, "layernorm", cfg.norm_eps)
        k_new, v_new = cm.gqa_project_kv(p["attn"], h, cfg, positions,
                                         use_rope=False)
        kc[:, pos:pos + 1] = k_new.to(kc.dtype)
        vc[:, pos:pos + 1] = v_new.to(vc.dtype)
        x = dec_block_apply(p, x, None, cfg, positions,
                            mem_kv=(cache["mk"][n], cache["mv"][n]),
                            kv_valid_len=pos + 1, self_kv=(kc, vc))
    x = cm.apply_norm(params["dec_norm"], x, "layernorm", cfg.norm_eps)
    logits = cm.logits_apply(params["embed"], x, cfg)
    return logits[:, 0], cache
