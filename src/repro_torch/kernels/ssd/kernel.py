"""Mamba-2 SSD chunked scan, forward: the hand-written Hopper kernel and its
wrapper.

The kernel is ``csrc/ssd.cu`` (built by ``kernels._build`` at first use);
see its header for the design. For a CUDA tensor the wrapper launches it on
the current stream or raises. For a CPU tensor, and only then, it computes
the plain version ``ref.ssd_chunked_ref`` over the same chunks.

``launches`` counts the kernel's launches in this process; a caller that
wants to show a run went through the kernel sets it to 0 before the run and
reads it after.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

STATE_DIMS = (16, 32, 64, 128)     # the N and P the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _lib():
    lib = _build.load("ssd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.ssd_fwd.restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def chunk_len(S: int, chunk: int) -> int:
    """The reference kernel's chunk rule: min(chunk, S), halved until it
    divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 3 or Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (BH,S,P), Bm = Cm (BH,S,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    BH, S, _ = x.shape
    if Bm.shape[:2] != (BH, S) or dt.shape != (BH, S) or A.shape != (BH,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if S == 0:
        raise ValueError("empty sequence")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, Bm, Cm must share float32 or bfloat16; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, Bm, Cm on different devices")


def ssd_flat(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (BH, S, P); dt: (BH, S) f32; A: (BH,) f32; Bm, Cm: (BH, S, N).
    Returns (y (BH, S, P) in x's dtype, hT (BH, N, P) f32), from a zero
    state."""
    global launches
    _check(x, dt, A, Bm, Cm)
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=Q)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    if N not in STATE_DIMS or P not in STATE_DIMS:
        raise ValueError(f"N={N}, P={P}: each must be in {STATE_DIMS}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm, Cm must be contiguous")
    y = torch.empty_like(x)
    hT = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
    if BH == 0:
        return y, hT
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                          hT.data_ptr(), _DTYPES[x.dtype], BH, S, Q, N, P,
                          stream)
    if err != 0:
        raise RuntimeError("ssd kernel launch failed: "
                           + lib.ssd_error_string(err).decode())
    launches += 1
    return y, hT
