"""Upload compression for device-side model aggregation (reduces xi_d on
the uplink, the paper's DMT latency component); the port of
``repro.core.compression``.

Top-k sparsification with error feedback (Stich et al.) and int8
quantize-dequantize, leaf-wise over delta trees. ``lead`` leading axes of
every leaf are independent (an experiment fleet's replica axis): each slab
keeps its own top-k and its own int8 scale.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree


def topk_mask(x: torch.Tensor, ratio: float, lead: int = 0) -> torch.Tensor:
    """Keep exactly the top-``ratio`` fraction of entries by magnitude
    (of each slab below the ``lead`` axes), ties broken toward the lower
    index, as ``jax.lax.top_k`` does. ``torch.topk`` promises no order
    among ties; a stable descending sort of ``|x|`` keeps equal magnitudes
    in index order, so the first k indices are ``top_k``'s."""
    if x.dim() == lead:
        return x
    flat = x.reshape(tuple(x.shape[:lead]) + (-1,))
    k = max(int(ratio * flat.shape[-1]), 1)
    idx = torch.sort(flat.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    out = torch.zeros_like(flat).scatter(-1, idx, flat.gather(-1, idx))
    return out.reshape(x.shape)


def compress_topk(delta, ratio: float, lead: int = 0):
    return tree.map(lambda t: topk_mask(t, ratio, lead), delta)


def compress_int8(delta, lead: int = 0):
    def q(t):
        t32 = t.float()
        dims = tuple(range(lead, t.dim()))
        amax = t32.abs().amax(dim=dims, keepdim=True) if dims else t32.abs()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        # torch.round rounds half to even, as jnp.round does
        qt = torch.clamp(torch.round(t32 / scale), -127, 127).to(torch.int8)
        return (qt.float() * scale).to(t.dtype)

    return tree.map(q, delta)


def compress(delta, method: str, ratio: float = 0.1, lead: int = 0):
    if method == "topk":
        return compress_topk(delta, ratio, lead)
    if method == "int8":
        return compress_int8(delta, lead)
    raise ValueError(method)


def compression_ratio(method: str, ratio: float = 0.1) -> float:
    """Effective uplink size multiplier (for the latency model's xi_d).

    topk: value+index per kept entry ~= 2x per-entry cost on ratio entries.
    int8: 8/32 of the dense float32 payload.
    """
    if method == "none":
        return 1.0
    if method == "topk":
        return min(2.0 * ratio, 1.0)
    if method == "int8":
        return 0.25
    raise ValueError(method)


def apply_with_error_feedback(delta, ef, method: str, ratio: float = 0.1,
                              lead: int = 0) -> Tuple:
    """compressed(delta + ef), new ef = residual."""
    corrected = tree.map(lambda d, e: d + e.to(d.dtype), delta, ef)
    comp = compress(corrected, method, ratio, lead)
    new_ef = tree.map(lambda c, z: (c - z).float(), corrected, comp)
    return comp, new_ef
