"""Decoder-only LM stack covering the dense, MoE, SSM and hybrid families:
attention (GQA or MLA) and Mamba-2 mixers, dense or MoE FFNs.

The stack = unrolled ``prologue`` blocks + ``n_periods`` repetitions of
``pattern``, with the pattern's params stacked on a leading ``n_periods``
axis as in the reference; the periods run as a Python loop, under
``torch.utils.checkpoint`` when ``cfg.remat`` (training: ``loss_fn``).
Caches follow the same tree. Prefill and decode write each layer's cache
in place (the reference returns an updated copy): an attention layer the
new k/v (an MLA layer its latent c_kv and k_rope), a Mamba layer its conv
window and SSM state, so a step moves no cache bytes and a layer's view of
the stacked cache stays current. MoE layers return the router's aux loss,
which ``_stack_forward`` sums.

A muP config (``cfg.mup``, granite) scales each sublayer's output by its
residual multiplier before the residual add. Traced, each attention
mixer call (GQA or MLA; in the training forward, the prefill and the
decode) is the span ``attn``; a Mamba mixer's is ``mamba``
(``models/mamba2.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry, tree
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models.common import Params


def _index(stacked, i: int):
    """The i-th slice of every leaf of a stacked params/cache tree."""
    if isinstance(stacked, dict):
        return {k: _index(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------------------
# one block
# --------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, spec: LayerSpec) -> Params:
    dt, dev = cm.pdtype(cfg), gen.device
    p = {"pre_norm": cm.norm_init(cfg.d_model, cfg.norm_kind, dt, dev)}
    if spec.mixer == "attn":
        p["attn"] = (cm.mla_init(gen, cfg) if cfg.attn_kind == "mla"
                     else cm.gqa_init(gen, cfg))
    elif spec.mixer == "mamba":
        p["mamba"] = mb.mamba_init(gen, cfg)
    else:
        raise ValueError(spec.mixer)
    if cfg.post_norm:
        p["post_norm"] = cm.norm_init(cfg.d_model, cfg.norm_kind, dt, dev)
    if spec.ffn != "none":
        p["mlp_norm"] = cm.norm_init(cfg.d_model, cfg.norm_kind, dt, dev)
        if spec.ffn == "moe":
            p["moe"] = cm.moe_init(gen, cfg)
        else:
            p["mlp"] = cm.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg)
        if cfg.post_norm:
            p["mlp_post_norm"] = cm.norm_init(cfg.d_model, cfg.norm_kind,
                                              dt, dev)
    return p


def _residual(x, a, cfg: ModelConfig):
    """x + a, the sublayer output ``a`` first scaled by a muP config's
    residual multiplier."""
    if cfg.mup is not None:
        a = a * cfg.mup.residual_multiplier
    return x + a


def _ffn(p: Params, x, cfg: ModelConfig, spec: LayerSpec,
         no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN sublayer with its residual. Returns (x, aux): a MoE layer's
    router aux loss (``no_drop`` sizes its capacity so no token drops),
    else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn != "none":
        h = cm.apply_norm(p["mlp_norm"], x, cfg.norm_kind, cfg.norm_eps)
        if spec.ffn == "moe":
            f, aux = cm.moe_apply(p["moe"], h, cfg, no_drop=no_drop)
        else:
            f = cm.mlp_apply(p["mlp"], h, cfg)
        if cfg.post_norm:
            f = cm.apply_norm(p["mlp_post_norm"], f, cfg.norm_kind,
                              cfg.norm_eps)
        x = _residual(x, f, cfg)
    return x, aux


def _mixer(p: Params, x, cfg: ModelConfig, spec: LayerSpec, positions):
    if spec.mixer != "attn":
        return mb.mamba_apply(p["mamba"], x, cfg)
    with telemetry.span("attn"):
        if cfg.attn_kind == "mla":
            return cm.mla_apply(p["attn"], x, cfg, causal=True,
                                positions=positions)
        return cm.gqa_apply(p["attn"], x, cfg, causal=True,
                            window=spec.window, positions=positions)


def block_apply(p: Params, x, cfg: ModelConfig, spec: LayerSpec,
                positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss)."""
    h = cm.apply_norm(p["pre_norm"], x, cfg.norm_kind, cfg.norm_eps)
    a = _mixer(p, h, cfg, spec, positions)
    if cfg.post_norm:
        a = cm.apply_norm(p["post_norm"], a, cfg.norm_kind, cfg.norm_eps)
    return _ffn(p, _residual(x, a, cfg), cfg, spec)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, batch: int, cap: int, device,
                     lead: Tuple[int, ...] = ()):
    """k/v (batch, cap, G, hd), or for MLA the latent: ckv (batch, cap, r)
    and kr (batch, cap, dr); in the compute dtype, after the ``lead``
    axes."""
    def zeros(*shape):
        return torch.zeros(lead + (batch, cap) + shape, dtype=cm.cdtype(cfg),
                           device=device)
    if cfg.attn_kind == "mla":
        return {"ckv": zeros(cfg.mla.kv_lora_rank),
                "kr": zeros(cfg.mla.qk_rope_head_dim)}
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": zeros(G, hd), "v": zeros(G, hd)}


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int, cap: int,
                     device="cpu", lead: Tuple[int, ...] = ()):
    if spec.mixer == "attn":
        return _attn_cache_init(cfg, batch, cap, device, lead)
    return mb.mamba_init_cache(cfg, batch, cm.cdtype(cfg), device, lead)


def init_cache(cfg: ModelConfig, batch: int, cap: int, device="cpu"):
    """Full-model cache: prologue list + per-pattern-position stacked."""
    pro = [layer_cache_init(cfg, s, batch, cap, device)
           for s in cfg.prologue]
    stack = [layer_cache_init(cfg, s, batch, cap, device, (cfg.n_periods,))
             for s in cfg.pattern]
    return {"prologue": pro, "stack": stack}


def _attn_decode(p: Params, h, cache, cfg: ModelConfig, spec: LayerSpec,
                 pos: int):
    """An attention layer's decode: writes the new token's k/v (its latent
    for MLA, which then attends in the latent space: absorbed) into
    ``cache`` in place and attends over the cache."""
    cap = next(iter(cache.values())).shape[1]
    if not 0 <= pos < cap:
        raise IndexError(f"decode position {pos} outside cache of {cap}")
    positions = torch.full((1,), pos, device=h.device)
    if cfg.attn_kind == "mla":
        ckv_new, kr_new = cm.mla_project_latent(p["attn"], h, cfg, positions)
        cache["ckv"][:, pos:pos + 1] = ckv_new.to(cache["ckv"].dtype)
        cache["kr"][:, pos:pos + 1] = kr_new.to(cache["kr"].dtype)
        return cm.mla_apply(p["attn"], h, cfg, causal=False,
                            positions=positions,
                            latent=(cache["ckv"], cache["kr"]),
                            kv_valid_len=pos + 1, absorbed=True)
    k_new, v_new = cm.gqa_project_kv(p["attn"], h, cfg, positions)
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    # window masking for local layers works through kv_valid_len + the
    # window term using absolute positions
    return cm.gqa_apply(p["attn"], h, cfg, causal=False, window=spec.window,
                        positions=positions, kv=(cache["k"], cache["v"]),
                        kv_valid_len=pos + 1)


def block_decode(p: Params, x, cache, cfg: ModelConfig, spec: LayerSpec,
                 pos: int) -> Tuple[torch.Tensor, dict]:
    """x: (B,1,D); pos: index of the new token. Writes its k/v (its latent
    for MLA; for a Mamba layer its conv window and SSM state) into
    ``cache`` in place and returns (x, cache). A MoE FFN runs with
    ``no_drop``."""
    h = cm.apply_norm(p["pre_norm"], x, cfg.norm_kind, cfg.norm_eps)
    if spec.mixer == "attn":
        with telemetry.span("attn"):
            a = _attn_decode(p, h, cache, cfg, spec, pos)
    else:
        a, cache = mb.mamba_decode_step(p["mamba"], h, cache, cfg)
    if cfg.post_norm:
        a = cm.apply_norm(p["post_norm"], a, cfg.norm_kind, cfg.norm_eps)
    x, _ = _ffn(p, _residual(x, a, cfg), cfg, spec, no_drop=True)
    return x, cache


def _attn_prefill(p: Params, h, cache, cfg: ModelConfig, spec: LayerSpec,
                  positions):
    """An attention layer's prefill: writes the prompt's k/v (the MLA
    latent) into ``cache`` and attends with queries at 0..S-1 over the k/v
    just projected, not projected again (the reference leaves the
    duplicate to XLA's CSE)."""
    S = h.shape[1]
    if cfg.attn_kind == "mla":
        ckv, kr = cm.mla_project_latent(p["attn"], h, cfg, positions)
        cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
        cache["kr"][:, :S] = kr.to(cache["kr"].dtype)
        return cm.mla_apply(p["attn"], h, cfg, causal=True, latent=(ckv, kr))
    k, v = cm.gqa_project_kv(p["attn"], h, cfg, positions)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cm.gqa_apply(p["attn"], h, cfg, causal=True, window=spec.window,
                        kv=(k, v))


def block_prefill(p: Params, x, cfg: ModelConfig, spec: LayerSpec,
                  positions, cap: int, cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Forward one block while building its decode cache. Returns
    (x, aux, cache). ``positions`` are the prompt's, 0..S-1 (a prefill
    from scratch). ``cap`` >= S is the cache capacity; the k/v (the MLA
    latent, or the conv window and SSM state) go into ``cache`` in place
    when given (a layer's view of the stacked cache), else into a new one.
    A MoE FFN runs with ``no_drop`` exactly when B*S <= 4096 (the
    reference's threshold: no-drop capacity grows with the group)."""
    B, S, _ = x.shape
    h = cm.apply_norm(p["pre_norm"], x, cfg.norm_kind, cfg.norm_eps)
    if cache is None:
        cache = layer_cache_init(cfg, spec, B, cap, x.device)
    if spec.mixer == "attn":
        with telemetry.span("attn"):
            a = _attn_prefill(p, h, cache, cfg, spec, positions)
    else:
        a, (conv_state, hT) = mb.mamba_apply(p["mamba"], h, cfg,
                                             return_state=True)
        # in place: ``cache`` may be this layer's view of the stacked cache
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(hT)
        # the conv state is a view of in_proj's output: free that before
        # the FFN
        del conv_state, hT
    if cfg.post_norm:
        a = cm.apply_norm(p["post_norm"], a, cfg.norm_kind, cfg.norm_eps)
    x, aux = _ffn(p, _residual(x, a, cfg), cfg, spec, no_drop=B * S <= 4096)
    return x, aux, cache


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``gen``'s device, drawn from ``gen``."""
    params = {"embed": cm.embed_init(gen, cfg),
              "final_norm": cm.norm_init(cfg.d_model, cfg.norm_kind,
                                         cm.pdtype(cfg), gen.device)}
    params["prologue"] = [block_init(gen, cfg, s) for s in cfg.prologue]
    stack = []
    for s in cfg.pattern:
        periods = [block_init(gen, cfg, s) for _ in range(cfg.n_periods)]
        stack.append(_stack(periods))
    params["stack"] = stack
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _remat(fn):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when grad
    mode is on: its activations are recomputed in backward, not kept."""
    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)
    return run


def _stack_forward(params, x, cfg: ModelConfig, positions):
    """Run prologue + the periods of the pattern. Returns (x, aux). With
    ``cfg.remat`` each prologue block and each period is checkpointed (the
    reference's ``jax.checkpoint``); with ``remat_group`` g > 1 dividing
    the periods, groups of g periods are checkpointed around their
    checkpointed periods (two-level remat)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prologue):
        blk = _remat(block_apply) if cfg.remat else block_apply
        x, a = blk(params["prologue"][i], x, cfg, spec, positions)
        aux = aux + a
    if not cfg.n_periods:
        return x, aux
    periods = list(zip(*[tree.unbind(t) for t in params["stack"]]))

    def body(x, aux, period):
        for pos, spec in enumerate(cfg.pattern):
            x, a = block_apply(period[pos], x, cfg, spec, positions)
            aux = aux + a
        return x, aux

    g = cfg.remat_group
    if cfg.remat and g > 1 and cfg.n_periods % g == 0:
        def group_body(x, aux, group):
            for period in group:
                x, aux = _remat(body)(x, aux, period)
            return x, aux

        for j in range(0, cfg.n_periods, g):
            x, aux = _remat(group_body)(x, aux, periods[j:j + g])
    else:
        step = _remat(body) if cfg.remat else body
        for period in periods:
            x, aux = step(x, aux, period)
    return x, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (logits (B,S,V) f32, aux loss)."""
    if positions is None:
        S = tokens.shape[1] if inputs_embeds is None else inputs_embeds.shape[1]
        positions = torch.arange(S, device=tokens.device)
    x = (cm.embed_apply(params["embed"], tokens, cfg)
         if inputs_embeds is None else inputs_embeds)
    x, aux = _stack_forward(params, x, cfg, positions)
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return cm.logits_apply(params["embed"], x, cfg), aux


def final_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """Backbone up to (and incl.) the final norm. Returns (x, aux)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = cm.embed_apply(params["embed"], tokens, cfg)
    x, aux = _stack_forward(params, x, cfg, positions)
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x, aux


def head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["embed"]["head"])


def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean token cross-entropy of ``batch["labels"]`` (masked by
    ``batch["mask"]`` when given) plus the aux loss."""
    x, aux = final_hidden(params, batch["tokens"], cfg)
    loss = cm.lm_head_loss(head_matrix(params, cfg), x, batch["labels"],
                           cfg, batch.get("mask"))
    return loss + aux


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            cap: Optional[int] = None):
    """Forward + cache build. Returns (last-position logits, cache)."""
    B, S = tokens.shape
    cap = cap or S
    if S > cap:
        raise ValueError(f"prompt of {S} tokens exceeds cache of {cap}")
    positions = torch.arange(S, device=tokens.device)
    cache = init_cache(cfg, B, cap, tokens.device)
    x = cm.embed_apply(params["embed"], tokens, cfg)
    for i, spec in enumerate(cfg.prologue):
        x, _, _ = block_prefill(params["prologue"][i], x, cfg, spec,
                                positions, cap, cache["prologue"][i])
    for n in range(cfg.n_periods):
        for pos, spec in enumerate(cfg.pattern):
            x, _, _ = block_prefill(_index(params["stack"][pos], n), x, cfg,
                                    spec, positions, cap,
                                    _index(cache["stack"][pos], n))
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    logits = cm.logits_apply(params["embed"], x[:, -1:, :], cfg)
    return logits[:, 0], cache


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B,) int; pos: the new token's index
    (attends to cache[:pos] + itself). Updates ``cache`` in place and
    returns (logits (B,V), cache)."""
    x = cm.embed_apply(params["embed"], tokens[:, None], cfg)
    for i, spec in enumerate(cfg.prologue):
        x, _ = block_decode(params["prologue"][i], x, cache["prologue"][i],
                            cfg, spec, pos)
    for n in range(cfg.n_periods):
        for ppos, spec in enumerate(cfg.pattern):
            x, _ = block_decode(_index(params["stack"][ppos], n), x,
                                _index(cache["stack"][ppos], n), cfg, spec,
                                pos)
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    logits = cm.logits_apply(params["embed"], x, cfg)
    return logits[:, 0], cache
