"""Seeded weights, drawn on the device leaf slice by leaf slice.

Every slice of a parameter (one layer of a stacked leaf, one embedding
table) has a key such as ``layers/3/mamba/in_proj/w`` and is drawn by its
own ``torch.Generator`` seeded from ``(seed, key)``. The program's tree and
the reference's per-layer dicts name their slices alike, so the reference
draws the very values the program was handed, one layer at a time, without
reading anything the program made.

The rule of a slice follows its leaf name: norm scales and ``D`` are ones,
biases zeros, the token table N(0, 0.02), ``conv_w`` N(0, 1/(taps x
channels)), ``dt_bias`` the inverse softplus of a log-uniform step in
[dt_min, dt_max], ``A_log`` the log of U(1, 16), and every other matrix
N(0, 1/fan_in) with fan_in its second-to-last size.
"""
from __future__ import annotations

import hashlib
import math

import torch

DT_MIN, DT_MAX = 1e-3, 1e-1


def leaf_seed(seed: int, key: str) -> int:
    digest = hashlib.blake2b(f"{int(seed)}:{key}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _generator(device, seed: int, key: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, key))
    return gen


def draw(key: str, shape, dtype, device, seed: int) -> torch.Tensor:
    """The slice ``key`` of ``shape`` in ``dtype`` on ``device``."""
    name = key.rsplit("/", 1)[-1]
    shape = tuple(int(s) for s in shape)
    if name in ("scale", "D"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ("b", "bias", "conv_b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = _generator(device, seed, key)
    if name in ("dt_bias", "A_log"):
        u = torch.empty(shape, dtype=torch.float32, device=device)
        u.uniform_(0.0, 1.0, generator=gen)
        if name == "A_log":
            return torch.log(1.0 + 15.0 * u).to(dtype)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                       + math.log(DT_MIN))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if name == "tok":
        std = 0.02
    elif name == "conv_w":
        std = 1.0 / math.sqrt(shape[0] * shape[1])
    else:
        std = 1.0 / math.sqrt(shape[-2])
    out = torch.empty(shape, dtype=dtype, device=device)
    out.normal_(0.0, std, generator=gen)
    return out


def fill(meta: torch.Tensor, key_of, device, seed: int,
         lead: str = "") -> torch.Tensor:
    """A tensor shaped as ``meta`` on ``device``. ``lead`` names its leading
    axis: "" (one slice), "layers" (slice i is ``key_of(i)``) or
    "clients" (every row the slice ``key_of(0)``, drawn once)."""
    out = torch.empty(tuple(meta.shape), dtype=meta.dtype, device=device)
    if not lead:
        out.copy_(draw(key_of(0), out.shape, out.dtype, device, seed))
        return out
    if lead == "clients":
        row = draw(key_of(0), out.shape[1:], out.dtype, device, seed)
        out.copy_(row.expand(out.shape))
        return out
    for i in range(out.shape[0]):
        out[i].copy_(draw(key_of(i), out.shape[1:], out.dtype, device, seed))
    return out
