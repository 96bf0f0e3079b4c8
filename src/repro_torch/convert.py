"""Parameter and CPSL-state trees between the reference package and the
port.

The reference's trees (``jax.device_get`` gives numpy arrays) keep their
structure and their ``(d_in, d_out)`` weight orientation, so ``x @ w``
holds on both sides.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """Map every array leaf of a dict/list/tuple tree to a tensor on
    ``device`` (cast to ``dtype`` when given); the structure is kept, with
    tuples becoming lists."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def cpsl_state_from_numpy(state, device):
    """A reference CPSL state (``jax.device_get`` of it, or a checkpoint's
    numpy tree) as the port's: every leaf keeps its dtype, so ``rng`` stays
    uint32[2] and ``step`` int32, conv weights stay HWIO, and tuples (sgd's
    empty optimizer state) stay tuples."""
    if isinstance(state, dict):
        return {k: cpsl_state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(cpsl_state_from_numpy(v, device) for v in state)
    return _tensor(state, device, None)


def cpsl_state_to_numpy(state):
    """The port's CPSL state as numpy arrays of the same dtypes, ready for
    ``jax.numpy.asarray`` in the reference."""
    if isinstance(state, dict):
        return {k: cpsl_state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(cpsl_state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()
