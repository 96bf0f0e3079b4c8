"""Plain float32 logits of the Mamba-2 LM as served (Dao & Gu,
arXiv:2405.21060), from the configuration file's sizes and weights drawn
again from the seed, one layer at a time: the embedding, the layers of
``reference/mamba2.py`` (``block``), the final RMSNorm and the head tied
to the embedding, as the served model has it (the CPSL split unties it).

The weights are the harness's draw (``harness/weights.py``), key by key,
but for the conv taps, drawn at the harness's rule, N(0, 1 / (taps x
channels)), times sqrt(channels) (``scales``): N(0, 1 / taps), a depthwise
conv's fan-in being its taps. At the harness's rule the conv's outputs
(x, B and C of the scan) are 1/sqrt(channels) of its inputs, the SSM
state's term C h is third-order small beside the rest of the layer, and a
decode step that leaves the state unwritten moves no logit past bf16's
rounding.

Each row runs alone, over the sequence padded with zeros to whole chunks
of the SSD (the chunk rule halves a chunk until it divides the length,
which at a length such as 8223 leaves chunks of one position): the
layers are causal, so no output reads a padded position.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.mamba2 import (block, dims, draw_f32, layer_shapes,
                                       rmsnorm)
from perfbench.reference.precision import Precision


def scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` times ``s`` in float32, rounded back to ``t``'s dtype (the
    program is handed these values)."""
    return (t.float() * s).to(t.dtype)


def conv_scale(conv_dim: int) -> float:
    return math.sqrt(conv_dim)


def scales(cfg: dict) -> dict:
    """{a layer's weight name: the factor its harness draw is scaled by}."""
    return {"mamba/conv_w": conv_scale(dims(cfg)[-1])}


def layer_params(cfg: dict, seed: int, layer: int, device) -> dict:
    pdt = getattr(torch, cfg["param_dtype"])
    mult = scales(cfg)
    p = {}
    for k, s in layer_shapes(cfg).items():
        w = draw_f32(cfg, seed, f"layers/{layer}/{k}", s, device)
        p[k] = scaled(w.to(pdt), mult[k]).float() if k in mult else w
    return p


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs, prompt: int, read_from: int, device,
           prec: Precision, prefill_rows: int):
    """seqs (R, T) tokens. Returns the logits at positions read_from..T-1,
    (R, T - read_from, V) float32. ``prompt`` and ``prefill_rows`` are
    the other references' terms; no layer here depends on them."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    t = seqs.shape[1]
    chunk = cfg["chunk_size"]
    table = draw_f32(cfg, seed, "embed/tok", (v, d), device)
    x = F.pad(table[seqs], (0, 0, 0, -t % chunk if t > chunk else 0))
    for layer in range(cfg["num_hidden_layers"]):
        p = layer_params(cfg, seed, layer, device)
        x = torch.cat([block(p, x[i:i + 1], cfg, prec)
                       for i in range(x.shape[0])])
        del p
    x = rmsnorm(x[:, read_from:t], draw_f32(cfg, seed, "final_norm/scale",
                                            (d,), device),
                cfg["rms_norm_eps"])
    return prec.mm(x, table.t())
