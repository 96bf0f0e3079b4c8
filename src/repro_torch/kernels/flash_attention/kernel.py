"""Flash-attention forward: the hand-written Hopper kernel and its wrapper.

The kernel is ``csrc/flash_attention.cu`` (built by ``kernels._build`` at
first use); see its header for the design. For a CUDA tensor the wrapper
launches it on the current stream or raises. For a CPU tensor, and only
then, it computes the plain version ``ref.attention_ref``. For a ``meta``
tensor (the dry run's shape propagation) it returns a ``meta`` output of
the kernel's shape and dtype and computes nothing. On the card and on
meta it reports the call to ``kernels.record_call`` (the dry run's op
counter cannot see a launch through ctypes; ``telemetry.LaunchCounter``
counts the launches).

The bf16 kernels read q, k and v in 16-byte pieces (TMA, ``cp.async``), so
a bf16 input whose base is not 16-byte aligned is refused, on the card and
on meta alike.

The kernel's output has no gradient. Training reaches it only through
``ops.flash_attention``'s ``autograd.Function``, so the wrapper refuses an
input that requires grad while grad mode is on: autograd would otherwise
see a constant, and the q/k/v projections would get no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, no_grad_inputs, record_call
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                        i, f, i, f, vp]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bf16_smem.argtypes = [i]
    lib.flash_attention_bf16_smem.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, kv_repeat: int):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (BHq,Sq,D), k = v (BHkv,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] * kv_repeat or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} with kv_repeat={kv_repeat}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def bf16_smem_bytes(D: int) -> int:
    """Dynamic shared memory a block of the bf16 kernel at head dim ``D``;
    builds the library."""
    got = _lib().flash_attention_bf16_smem(D)
    if got < 0:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    return got


def flash_attention_flat(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         kv_repeat: int = 1) -> torch.Tensor:
    """q: (BHq, Sq, D); k, v: (BHkv, Skv, D) with BHq == BHkv * kv_repeat
    (GQA: query head h reads kv head h // kv_repeat). Returns (BHq, Sq, D)
    in q's dtype. Raises for an input that requires grad in grad mode
    (``no_grad_inputs``)."""
    _check(q, k, v, kv_repeat)
    no_grad_inputs("flash_attention_flat", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset,
                             kv_repeat=kv_repeat)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if BH > 65535 or q_offset < 0 or window < 0:
        raise ValueError(f"unsupported BH={BH}, q_offset={q_offset}, "
                         f"window={window}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bf16 q, k, v need 16-byte aligned bases (the "
                         "kernel reads them in 16-byte pieces)")
    out = torch.empty_like(q)
    if Sq == 0 or BH == 0:
        return out
    if q.device.type == "meta":
        record_call("flash_attention", (q, k, v), (out,))
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], BH, Sq, Skv, D, kv_repeat, int(causal),
            int(window), float(softcap), int(q_offset),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    record_call("flash_attention", (q, k, v), (out,))
    return out
