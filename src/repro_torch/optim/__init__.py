"""Functional optimizers over tensor trees: SGD(+momentum), AdamW, grad
clipping, schedules (the port of ``repro.optim``).

    opt = sgd(0.05)
    state = opt.init(params)
    params, state = opt.step(grads, state, params, step=i)

Written over trees of (possibly K-stacked per-client) tensors, not with
``torch.optim``: every step returns new tensors and leaves its inputs as
they were, and the state trees have the reference's structure (sgd's is an
empty tuple, momentum's a params-shaped tree, adamw's ``{"m", "v"}``), so
checkpoints interchange between the packages.

``lr_scale`` (a scalar or 0-d tensor) multiplies the schedule's rate; with
a base lr of 1.0 the multiply is exact, so a scaled run reproduces the run
whose lr was set directly.

Experiment fleets stack E replicas on a leading axis of every leaf. Their
``step`` and ``lr_scale`` are then (E,) tensors, and a rate of shape (E,)
multiplies each replica's slab of every leaf (``per_replica``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch import tree

Schedule = Union[float, Callable]


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


def _scaled_lr(lr: Schedule, step, lr_scale):
    lr_t = _lr_at(lr, step)
    return lr_t if lr_scale is None else lr_t * lr_scale


def per_replica(x, p: torch.Tensor):
    """A per-replica (E,) tensor shaped to broadcast against a tensor whose
    leading axis is the replica axis; scalars and 0-d tensors as they
    are."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * (p.dim() - 1))
    return x


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(n, 1e-12), max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), grads), n


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable  # (grads, state, params, step, lr_scale) -> (params, state)
    name: str = "opt"


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return ()

    def step_fn(grads, state, params, step=0, lr_scale=None):
        lr_t = _scaled_lr(lr, step, lr_scale)
        new = tree.map(
            lambda p, g: p - (per_replica(lr_t, p) * g.float()).to(p.dtype),
            params, grads)
        return new, state

    return Optimizer(init, step_fn, "sgd")


def momentum(lr: Schedule, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def step_fn(grads, state, params, step=0, lr_scale=None):
        lr_t = _scaled_lr(lr, step, lr_scale)
        new_m = tree.map(lambda m, g: beta * m + g.float(), state, grads)
        new_p = tree.map(
            lambda p, m: p - (per_replica(lr_t, p) * m).to(p.dtype), params,
            new_m)
        return new_p, new_m

    return Optimizer(init, step_fn, "momentum")


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree.map(zeros, params), "v": tree.map(zeros, params)}

    def step_fn(grads, state, params, step=0, lr_scale=None):
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        lr_t = _scaled_lr(lr, step, lr_scale)
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree.map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t)

        def upd(p, m_, v_):
            u = ((m_ / per_replica(bc1, p))
                 / (torch.sqrt(v_ / per_replica(bc2, p)) + eps))
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p - per_replica(lr_t, p) * u).to(p.dtype)

        return tree.map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, step_fn, "adamw")


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return f


def make(name: str, lr: Schedule, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, kw.get("momentum", 0.9))
    if name == "adamw":
        return adamw(lr, weight_decay=kw.get("weight_decay", 0.0))
    if name == "adamw_mixed":
        return adamw_mixed(lr, weight_decay=kw.get("weight_decay", 0.0))
    raise ValueError(name)


def adamw_mixed(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Mixed-precision AdamW: the model params keep their (e.g. bf16)
    dtype; the state holds the f32 master copy and the moments
    (``{"master", "m", "v"}``, the reference's structure). The master
    copy takes ``adamw``'s step; the params are its cast."""
    inner = adamw(lr, b1, b2, eps, weight_decay)

    def init(params):
        master = tree.map(lambda p: p.float().clone(), params)
        return {"master": master, **inner.init(master)}

    def step_fn(grads, state, params, step=0, lr_scale=None):
        master, moments = inner.step(
            grads, {"m": state["m"], "v": state["v"]}, state["master"],
            step, lr_scale=lr_scale)
        new_p = tree.map(lambda mp, p: mp.to(p.dtype), master, params)
        return new_p, {"master": master, **moments}

    return Optimizer(init, step_fn, "adamw_mixed")
