"""The reference's CPSL training modules (and the LM modules the split-LM
training runs), for the port's parity tests.

On jax 0.9 ``repro.core.cpsl`` and ``repro.sim`` (which
``repro.train.trainer`` imports) do not import as they stand:

- ``core/cpsl.py:71`` asks ``prim not in _batching.primitive_batchers``,
  and jax 0.9's ``PrimitiveBatchersProxy`` has no ``__contains__`` and is
  not iterable. jax 0.9 already batches ``optimization_barrier``, so the
  patch answers True and the reference registers nothing.
- ``sim/fleet.py:70`` imports ``jax.experimental.enable_x64``, which jax
  0.9 no longer has; the patch aliases it to ``jax.enable_x64(True)``.

``reference()`` applies both patches, imports the modules, and on exit
takes the patches back and drops from ``sys.modules`` (and from their
parent packages) every ``repro`` module that the import brought in.
Test files call it from a module-scoped fixture, never at import, so the
reference's own test files collect, import and fail exactly as they do
without it, in whichever xdist worker they land after these.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
import types

MODULES = {
    "cpsl": "repro.core.cpsl",
    "trainer": "repro.train.trainer",
    "splitting": "repro.core.splitting",
    "lenet": "repro.models.lenet",
    "pipeline": "repro.data.pipeline",
    "synthetic": "repro.data.synthetic",
    "resource": "repro.core.resource",
    "latency": "repro.core.latency",
    "channel": "repro.core.channel",
    "profile": "repro.core.profile",
    "compression": "repro.core.compression",
    "optim": "repro.optim",
    "checkpointer": "repro.checkpoint.checkpointer",
    "configs": "repro.configs.base",
    "streams": "repro.streams",
    "batched": "repro.sim.batched",
    "registry": "repro.configs.registry",
    "transformer": "repro.models.transformer",
    "common": "repro.models.common",
    "mamba2": "repro.models.mamba2",
    "fa_ops": "repro.kernels.flash_attention.ops",
    "ssd_ops": "repro.kernels.ssd.ops",
}

_MISSING = object()


@contextlib.contextmanager
def patched():
    import jax
    import jax.experimental
    from jax._src.interpreters import batching
    proxy = getattr(batching, "PrimitiveBatchersProxy", None)
    saved = [(jax.experimental, "enable_x64",
              getattr(jax.experimental, "enable_x64", _MISSING))]
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    if proxy is not None:
        saved.append((proxy, "__contains__",
                      proxy.__dict__.get("__contains__", _MISSING)))
        proxy.__contains__ = lambda self, key: True
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def _forget(names) -> None:
    for name in names:
        mod = sys.modules.pop(name)
        parent, _, child = name.rpartition(".")
        if getattr(sys.modules.get(parent), child, None) is mod:
            delattr(sys.modules[parent], child)


@contextlib.contextmanager
def reference():
    """The reference modules by short name, imported under ``patched()``;
    on exit the patches and the modules the import added are gone."""
    before = set(sys.modules)
    try:
        with patched():
            yield types.SimpleNamespace(**{
                k: importlib.import_module(v) for k, v in MODULES.items()})
    finally:
        _forget(sorted(n for n in set(sys.modules) - before
                       if n.split(".")[0] == "repro"))
