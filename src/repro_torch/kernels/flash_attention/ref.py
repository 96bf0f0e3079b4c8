"""Plain PyTorch version of the flash-attention kernel.

The kernel layout is flat-head:
    q: (BHq, Sq, D)  k, v: (BHkv, Skv, D)   with BHq == BHkv * kv_repeat
Semantics: softmax(q k^T / sqrt(D) [+softcap] [+causal/window mask]) v,
with absolute positions q_offset + i for queries; query head b reads kv
head b // kv_repeat.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0,
                  kv_repeat: int = 1) -> torch.Tensor:
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=0)
        v = v.repeat_interleave(kv_repeat, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
