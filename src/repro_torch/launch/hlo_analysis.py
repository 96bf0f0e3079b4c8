"""FLOP, byte and memory count of one step, for the roofline (the port of
``repro.launch.hlo_analysis``).

The reference parses the compiled, partitioned HLO text. Eager PyTorch
has no HLO, so this module counts the step's aten ops as they run, from a
``TorchDispatchMode`` (``OpCounter``). It works the same on ``meta``
tensors (the dry run: shapes only, nothing computed) and on CUDA tensors
(the card), and the two counts agree because the op sequence is the same.
Per op:

  - FLOPs: ``torch.utils.flop_counter``'s registered formulas (mm, bmm,
    addmm, baddbmm, convolution and its backward, SDPA): 2 * prod(result)
    * prod(contracting), as the reference counts a dot or a convolution.
  - HBM bytes: operand + result bytes of every op that is not a view or
    metadata op (``view``, ``_unsafe_view``, ``expand``, ``transpose``,
    ``permute``, ``slice``, ``select``, ``as_strided``, ``detach``,
    ``alias``, ...; an ``empty*`` allocation moves nothing; a ``*_like``
    or other factory writes its result only). **Deliberate difference:**
    the reference leaves standalone elementwise ops out, because the TPU
    fuses them into their neighbours; eager PyTorch launches each one as
    its own kernel, which reads and writes device memory, so they count
    here.
  - Peak live bytes: each storage an op creates is added when it appears
    and subtracted by a ``weakref.finalize`` when it dies; the step's
    arguments (params, optimizer state, batch) are live from the start.
    The count sees neither the caching allocator's rounding nor library
    workspaces (cuBLAS).
  - Custom calls: the hand-written kernels launch through ``ctypes``, not
    as aten ops. Each wrapper reports its launch (``kernels.record_call``),
    on the card and on its ``meta`` path, and it counts as the
    reference's parse counts a Pallas custom-call: operand and result
    bytes, 0 FLOPs.

All numbers are for the one card (no collectives: ``coll`` stays empty).
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

# ops that move no data although their schema is no view
_NO_BYTES = {"_unsafe_view", "_reshape_alias", "detach", "alias", "empty",
             "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "set_", "resize_", "record_stream"}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (at most one level of
    list/tuple nesting, as aten schemas have)."""
    out = []
    for x in (tree.values() if isinstance(tree, dict) else
              tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class HLOStats:
    """One step's count. ``flops``, ``hbm_bytes`` and ``coll`` (collective
    bytes by kind, empty on one card) as in the reference; beside them the
    custom calls by kernel name and the memory: ``argument_bytes`` (the
    arguments' storages), ``output_bytes`` (new storages the outputs
    hold), ``alias_bytes`` (argument storages the outputs hold) and
    ``peak_bytes`` (live storage at its highest, arguments included)."""

    def __init__(self):
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = defaultdict(float)
        self.custom_calls: Dict[str, int] = defaultdict(int)
        self.n_ops = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self.peak_bytes = 0

    @property
    def collective_bytes(self):
        return sum(self.coll.values())


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (in any thread
    the autograd engine runs the step's backward on) and every hand-kernel
    call reported to ``kernels.record_call``. ``live``: a tree of tensors
    alive from the start (the step's arguments)."""

    def __init__(self, live=()):
        super().__init__()
        self.stats = HLOStats()
        self._live: Dict[int, weakref.ref] = {}
        self._bytes = 0
        for t in _leaves(live):
            self._track(t)
        self.stats.argument_bytes = self._bytes
        self._arg_keys = set(self._live)

    # -- live storage ------------------------------------------------------

    def _track(self, t: torch.Tensor):
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = weakref.ref(s, functools.partial(self._free, key,
                                                           n))
        self._bytes += n
        if self._bytes > self.stats.peak_bytes:
            self.stats.peak_bytes = self._bytes

    def _free(self, key: int, n: int, _ref):
        if self._live.pop(key, None) is not None:
            self._bytes -= n

    def __enter__(self):
        kernels.observers.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.observers.remove(self)
        self._live.clear()
        return super().__exit__(*exc)

    def finish(self, out) -> HLOStats:
        """Attribute the outputs' storages (call before leaving)."""
        seen = set()
        for t in _leaves(out):
            s = t.untyped_storage()
            if s._cdata in seen:
                continue
            seen.add(s._cdata)
            if s._cdata in self._arg_keys:
                self.stats.alias_bytes += s.nbytes()
            else:
                self.stats.output_bytes += s.nbytes()
        return self.stats

    # -- counting ----------------------------------------------------------

    def custom_call(self, name: str, operands, results):
        self.stats.custom_calls[name] += 1
        self.stats.hbm_bytes += _nbytes(operands) + _nbytes(results)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs)
        kind = _KIND.get(func)
        if kind is None:
            kind = _KIND[func] = _kind(func)
        flop_fn, moves, factory, functional = kind
        out = (_meta_call(func, args, kwargs) if functional and ins
               and all(t.is_meta for t in ins) else func(*args, **kwargs))
        outs = _tensors(out)
        # an input may be new to the count: ``torch.tensor(...)`` builds
        # its tensor below the dispatcher on some devices
        for t in ins:
            self._track(t)
        for t in outs:
            self._track(t)
        if moves is None:            # lift_fresh: seen on some devices only
            return out
        st = self.stats
        st.n_ops += 1
        if flop_fn is not None:
            st.flops += flop_fn(*args, **kwargs, out_val=out)
        if moves:
            st.hbm_bytes += _nbytes(outs) + (
                0 if factory or not ins else _nbytes(ins))
        return out


_KIND = {}


def _kind(func):
    """(flop formula or None, moves bytes (None: not counted at all),
    writes its result only, functional: neither a view nor a mutation)."""
    packet = func.overloadpacket
    name = packet.__name__
    if name == "lift_fresh":
        return None, None, False, False
    return (flop_registry.get(packet),
            not (func.is_view or name in _NO_BYTES),
            name.endswith("_like"),
            not (func.is_view or func._schema.is_mutable
                 or name in _NO_BYTES))


# A functional op's outputs on ``meta`` are a function of its arguments'
# metadata. Many meta kernels are Python references (~0.2 ms a call for a
# pointwise op), and a step repeats the same ops at the same shapes for
# every layer, client and tile, so their outputs' metadata is memoized.
_META_OUT = {}


def _key(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(e) for e in x)
    return x


def _meta_call(func, args, kwargs):
    key = (func, _key(args), tuple((k, _key(v)) for k, v in kwargs.items()))
    try:
        spec = _META_OUT.get(key)
    except TypeError:                # an unhashable argument
        return func(*args, **kwargs)
    if spec is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        if not all(isinstance(t, torch.Tensor) for t in outs):
            return out
        ins = {t.untyped_storage()._cdata
               for t in _tensors(args) + _tensors(kwargs)}
        if any(t.untyped_storage()._cdata in ins for t in outs):
            _KIND[func] = _KIND[func][:3] + (False,)    # it aliases
            return out
        spec = [(tuple(t.shape), t.stride(), t.dtype) for t in outs]
        _META_OUT[key] = (spec[0] if isinstance(out, torch.Tensor)
                          else spec)
        return out
    if isinstance(spec, tuple):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                   device="meta")
    return tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                 for sh, st, dt in spec)


def analyze(step, *args, **kwargs):
    """Run ``step(*args, **kwargs)`` once under an ``OpCounter`` whose
    live set starts with the arguments. Returns ``(HLOStats, out)``."""
    with OpCounter(live=(args, kwargs)) as counter:
        out = step(*args, **kwargs)
        stats = counter.finish(out)
    return stats, out


def report(stats: HLOStats) -> dict:
    """The reference's ``parsed`` record of one step."""
    return {
        "parsed_flops_per_device": stats.flops,
        "parsed_hbm_bytes_per_device": stats.hbm_bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "collectives_by_kind": {k: int(v) for k, v in stats.coll.items()},
    }
