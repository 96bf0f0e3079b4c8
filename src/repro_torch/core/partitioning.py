"""Logical-axis partitioning on one card (the port of
``repro.core.partitioning``).

The reference annotates activations and params with *logical* axis names;
a rule table maps them to mesh axes, and ``shard`` emits XLA sharding
constraints under an installed mesh. The port runs on one card, so it
keeps the tables and the resolution logic (``_resolve``, ``_fit``,
``spec``, ``param_specs``: plain data and pure functions of a mesh's
``axis_names`` and ``shape``) and drops the placement: ``shard`` is the
identity, ``sharding`` and ``named_shardings`` return ``None``,
``spmd_client_axes`` returns ``()`` and ``axis_size`` is 1 under no mesh or
a one-card mesh. A ``PartitionSpec`` is a tuple with one entry per dim
(``None``, a mesh axis name or a tuple of them). The port's models do not
call ``shard``: sharding is left out on purpose.
"""
from __future__ import annotations

import re
import threading
from typing import Optional, Sequence

from repro_torch import tree

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "clients": ("pod", "data"),     # stacked CPSL client axis
    "batch": ("pod", "data"),
    "seq": None,                    # the reference leaves the residual
                                    # stream's seq unsharded
    "kv_seq": "model",              # decode KV caches: shard seq over model
    "long_seq": ("data", "model"),  # batch=1 long-context: shard seq hard
    "embed": None,                  # d_model replicated at block boundary
    "heads": "model",
    "q_seq": "model",               # seq-parallel attention fallback
    "ff": "model",
    "vocab": "model",
    "expert": "data",
    "expert_ff": "model",           # expert banks: 2D (expert x ff)
    "ce_batch": ("pod", "data"),    # CE chunks: batch over data only so
    "ce_vocab": "model",            # vocab (and dW) shard over model
    "fsdp": "data",
    "layers": None,
    "conv": None,
    "state": None,
}

# Pure-FSDP profile: data parallelism over the whole mesh, weights
# ZeRO-3-sharded over (data, model).
FSDP_RULES = {
    "clients": ("pod", "data", "model"),
    "batch": ("pod", "data", "model"),
    "seq": None,
    "kv_seq": "model",
    "long_seq": ("data", "model"),
    "embed": None,
    "heads": None,
    "q_seq": None,
    "ff": None,
    "vocab": "model",              # weights only; activation constraints
    "expert": "data",              # drop duplicate axes automatically
    "expert_ff": "model",
    "ce_batch": ("pod", "data"),
    "ce_vocab": "model",
    "fsdp": ("data", "model"),
    "layers": None,
    "conv": None,
    "state": None,
}

PROFILES = {"tp": DEFAULT_RULES, "fsdp": FSDP_RULES}


class _Ctx(threading.local):
    mesh = None
    rules: dict = dict(DEFAULT_RULES)
    excluded: tuple = ()


_CTX = _Ctx()


class exclude_axes:
    """Mesh axes that inner specs may not use (the reference's scope for
    ``vmap(spmd_axis_name=axes)`` bodies)."""

    def __init__(self, axes):
        self.axes = tuple(axes or ())

    def __enter__(self):
        self._prev = _CTX.excluded
        _CTX.excluded = tuple(set(self._prev) | set(self.axes))
        return self

    def __exit__(self, *exc):
        _CTX.excluded = self._prev
        return False


def enable(mesh, rules: Optional[dict] = None, profile: str = "tp") -> None:
    _CTX.mesh = mesh
    _CTX.rules = dict(PROFILES[profile])
    if rules:
        _CTX.rules.update(rules)


def disable() -> None:
    _CTX.mesh = None


def active_mesh():
    return _CTX.mesh


class use_mesh:
    """Context manager: install mesh (+rule overrides) for spec resolution."""

    def __init__(self, mesh, rules: Optional[dict] = None,
                 profile: str = "tp"):
        self.mesh, self.rules, self.profile = mesh, rules, profile

    def __enter__(self):
        self._prev = (_CTX.mesh, _CTX.rules)
        enable(self.mesh, self.rules, self.profile)
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._prev
        return False


def _resolve(axis: Optional[str]):
    if axis is None:
        return None
    rule = _CTX.rules.get(axis, None)
    if rule is None:
        return None
    mesh_axes = _CTX.mesh.axis_names
    if isinstance(rule, tuple):
        present = tuple(a for a in rule if a in mesh_axes
                        and a not in _CTX.excluded)
        return present if present else None
    if rule in _CTX.excluded:
        return None
    return rule if rule in mesh_axes else None


def _fit(r, dim_size: int):
    """Shrink a resolved mesh-axis assignment until it divides dim_size
    (tuples drop trailing axes); None if nothing fits."""
    if r is None:
        return None
    if isinstance(r, tuple):
        rr = tuple(r)
        while rr:
            n = 1
            for a in rr:
                n *= _CTX.mesh.shape[a]
            if dim_size % n == 0:
                return rr if len(rr) > 1 else rr[0]
            rr = rr[:-1]
        return None
    return r if dim_size % _CTX.mesh.shape[r] == 0 else None


def spec(*axes: Optional[str]) -> tuple:
    """Logical axes -> a PartitionSpec tuple under the active rules/mesh."""
    return tuple(_resolve(a) for a in axes)


def axis_size(logical: Optional[str]) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 if inactive)."""
    if _CTX.mesh is None:
        return 1
    r = _resolve(logical)
    if r is None:
        return 1
    if isinstance(r, tuple):
        n = 1
        for a in r:
            n *= _CTX.mesh.shape[a]
        return n
    return _CTX.mesh.shape[r]


def shard(x, *axes: Optional[str]):
    """The identity: one card holds every tensor whole."""
    return x


def sharding(*axes: Optional[str]):
    """``None``: no placement on one card."""
    return None


def spmd_client_axes(K: int):
    """``()``: the client axis is never split across cards."""
    return ()


# --------------------------------------------------------------------------
# parameter partition specs, matched by path
# --------------------------------------------------------------------------

# (regex on 'a/b/c' path, logical axes per dim of the leaf)
# Stacked scan params get a leading 'layers' axis prepended automatically
# when rank exceeds the rule length by one.
PARAM_RULES = [
    (r"embed/tok$", ("vocab", "embed_w")),
    (r"embed/head$", ("embed", "vocab")),
    (r"(^|/)head$", ("embed", "vocab")),
    (r"(router)$", ("embed", None)),
    (r"moe/w_gate$", ("expert", None, "expert_ff")),
    (r"moe/w_up$", ("expert", None, "expert_ff")),
    (r"moe/w_down$", ("expert", "expert_ff", None)),
    (r"(wq|wk|wv|w_up|w_gate|w_dkv|w_uk|w_uv|in_proj)/w$", ("fsdp", "ff")),
    (r"(wo|w_down|out_proj)/w$", ("ff", "fsdp")),
    (r"conv_w$", (None, None)),
    (r".*", None),  # biases, norms, scalars: replicated
]

# embed_w: vocab-sharded table keeps its d_model dim replicated
_EXTRA_LOGICAL = {"embed_w": None}


def _resolve_param(axis):
    if axis in _EXTRA_LOGICAL:
        return _EXTRA_LOGICAL[axis]
    return _resolve(axis)


def param_specs(params, stacked_prefixes: Sequence[str] = ("stack",
                                                           "enc_stack",
                                                           "dec_stack")):
    """A tree of PartitionSpec tuples for a param tree, by path rules
    (leaves need ``shape``; a tensor, meta or not, will do)."""
    out = []
    for path, leaf in tree.flatten_with_path(params):
        ps = "/".join(str(p) for p in path)
        stacked = any(re.search(rf"(^|/){pfx}/", ps)
                      for pfx in stacked_prefixes)
        chosen = None
        for pat, axes in PARAM_RULES:
            if re.search(pat, ps):
                chosen = axes
                break
        ndim = len(leaf.shape)
        rk = ndim - (1 if stacked else 0)
        if chosen is None or rk != len(chosen):
            out.append(())
            continue
        dims = ([None] if stacked else []) \
            + [_resolve_param(a) for a in chosen]
        # fit to dims (e.g. vocab 50280 on 16-way model) and drop
        # duplicate mesh axes
        used = set()
        fitted = []
        for i, r in enumerate(dims):
            r = _fit(r, leaf.shape[i])
            if r is not None:
                parts = r if isinstance(r, tuple) else (r,)
                if any(p in used for p in parts):
                    parts = tuple(p for p in parts if p not in used)
                    r = _fit(parts or None, leaf.shape[i]) if parts else None
                if r is not None:
                    used.update(r if isinstance(r, tuple) else (r,))
            fitted.append(r)
        out.append(tuple(fitted))
    return tree.unflatten_like(params, out)


def named_shardings(params, mesh=None, **kw):
    """``None``: no placement on one card."""
    return None
