"""Mamba-2 SSD chunked scan, forward: the hand-written Hopper kernel and its
wrappers.

The kernel is ``csrc/ssd.cu`` (built by ``kernels._build`` at first use);
see its header for the design. It reads the model's layout as it is: x
(B, S, H, P) and dt (B, S, H) at any strides, B and C once per group
(B, S, G, N). ``ssd_grouped`` is that entry; ``ssd_flat`` keeps the
reference's flat per-head signature and calls it on strided views of its
inputs (one batch, one head per group), so neither copies anything.

For a CUDA tensor a wrapper launches the kernel on the current stream or
raises. For a CPU tensor, and only then, it computes the plain version
(``ref.ssd_grouped_ref``: ``ssd_chunked_ref`` over the same chunks). For
a ``meta`` tensor (the dry run's shape propagation) it allocates what the
card would (y, hT in f32 and the bf16 path's scratch) on ``meta`` and
computes nothing. On the card and on meta it reports the call to
``kernels.record_call`` (the dry run's op counter cannot see a launch
through ctypes; ``telemetry.LaunchCounter`` counts wrapper calls that
launched the kernel: one call runs two CUDA kernels in bf16, the chained
pass and the small kernel that first zeroes its flags, one in float32).

The kernel's outputs have no gradient: in grad mode the wrappers refuse an
input that requires grad (``no_grad_inputs``), and training reaches the
kernel only through ``ops.ssd``'s ``autograd.Function``.

The bf16 path is one chained pass over the chunks: each (batch, head)
carries its state from one item of chunks to the next through two f32
slots in device memory, ordered by a flag. Its scratch (``scratch``) is
the slots, the flags and a ticket counter, ``scratch_bytes`` in all,
whatever the number of chunks S / Q.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, no_grad_inputs, record_call
from repro_torch.kernels.ssd.ref import ssd_grouped_ref

STATE_DIMS = (16, 32, 64, 128)     # the N and P the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLAG_BYTES = 4                     # an int32 flag a (batch, head)


@functools.cache
def _lib():
    lib = _build.load("ssd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                            i, i, i, i,
                            ctypes.POINTER(ctypes.c_longlong), vp]
    lib.ssd_fwd.restype = i
    lib.ssd_bf16_smem.argtypes = [i, i]
    lib.ssd_bf16_smem.restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def bf16_smem_bytes(N: int, P: int) -> int:
    """Dynamic shared memory a block of the bf16 kernel at (N, P); builds
    the library."""
    got = _lib().ssd_bf16_smem(N, P)
    if got < 0:
        raise ValueError(f"N={N}, P={P}: each must be in {STATE_DIMS}")
    return got


def chunk_len(S: int, chunk: int) -> int:
    """The reference kernel's chunk rule: min(chunk, S), halved until it
    divides S."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def _check_types(x, dt, A, Bm, Cm):
    if x.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, Bm, Cm must share float32 or bfloat16; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, Bm, Cm on different devices")


def scratch_bytes(BH: int, P: int, N: int) -> int:
    """The bf16 path's scratch for BH (batch, head) pairs: two f32 (P, N)
    state slots and a flag each, and one int32 ticket counter."""
    return BH * (2 * N * P * 4 + FLAG_BYTES) + 4


def scratch(BH: int, P: int, N: int, device):
    """The bf16 path's scratch, uninitialised (the kernel zeroes the flags
    and the ticket on its stream): slots (BH, 2, P, N) f32 and flags
    (BH + 1,) int32, the last the ticket counter."""
    return (torch.empty((BH, 2, P, N), dtype=torch.float32, device=device),
            torch.empty((BH + 1,), dtype=torch.int32, device=device))


def _check_grouped(x, dt, A, Bm, Cm):
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,S,H,P), Bm = Cm (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B_, S, H, _ = x.shape
    G = Bm.shape[2]
    if (Bm.shape[:2] != (B_, S) or dt.shape != (B_, S, H)
            or A.shape != (H,) or G == 0 or H % G):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    _check_types(x, dt, A, Bm, Cm)


def _launch(x, dt, A, Bm, Cm, y, Q: int) -> torch.Tensor:
    """The kernel on model-layout tensors (y the output, any strides);
    returns hT (B, H, N, P) f32."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD kernel for device {x.device}")
    if N not in STATE_DIMS or P not in STATE_DIMS:
        raise ValueError(f"N={N}, P={P}: each must be in {STATE_DIMS}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm, y)):
        raise ValueError("x, Bm, Cm and y must be contiguous in their last "
                         "dim")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1])
            for t in (x, Bm, Cm)):
        # the bf16 path reads them by TMA: 16-byte aligned base and strides
        raise ValueError("bf16 x, Bm, Cm need 16-byte aligned rows: base "
                         "and strides a multiple of 8 elements")
    A = A.contiguous()
    hT = torch.empty((B_, H, N, P), dtype=torch.float32, device=x.device)
    if B_ * H == 0:
        return hT
    if x.dtype == torch.bfloat16:
        slots, flags = scratch(B_ * H, P, N, x.device)
        ptrs = (slots.data_ptr(), flags.data_ptr())
    else:
        ptrs = (None, None)
    if x.device.type == "meta":
        record_call("ssd", (x, dt, A, Bm, Cm), (y, hT))
        return hT
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *y.stride()[:3])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                          hT.data_ptr(), *ptrs, _DTYPES[x.dtype], B_, S, H,
                          H // G, Q, N, P, strides, stream)
    if err != 0:
        raise RuntimeError("ssd kernel launch failed: "
                           + lib.ssd_error_string(err).decode())
    record_call("ssd", (x, dt, A, Bm, Cm), (y, hT))
    return hT


def ssd_grouped(x, dt, A, Bm, Cm, *, chunk: int = 128, out=None):
    """Model layout: x (B, S, H, P) and dt (B, S, H) f32 at any strides,
    A (H,) f32, Bm and Cm (B, S, G, N) per group, head h reading group
    h // (H / G). Returns (y (B, S, H, P) in x's dtype, hT (B, H, N, P)
    f32), from a zero state; y is written into ``out`` when given (any
    strides, the last dim contiguous). Raises for an input that requires
    grad in grad mode."""
    _check_grouped(x, dt, A, Bm, Cm)
    no_grad_inputs("ssd_grouped", x, dt, A, Bm, Cm)
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"out must match x: {tuple(out.shape)} "
                         f"{out.dtype} {out.device}")
    Q = chunk_len(x.shape[1], chunk)
    if x.device.type == "cpu":
        y, hT = ssd_grouped_ref(x, dt, A, Bm, Cm, chunk=Q)
        return (y, hT) if out is None else (out.copy_(y), hT)
    y = out if out is not None else torch.empty(x.shape, dtype=x.dtype,
                                                device=x.device)
    return y, _launch(x, dt, A, Bm, Cm, y, Q)


def ssd_flat(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (BH, S, P); dt: (BH, S) f32; A: (BH,) f32; Bm, Cm: (BH, S, N).
    Returns (y (BH, S, P) in x's dtype, hT (BH, N, P) f32), from a zero
    state: ``ssd_grouped`` on views of one batch of BH heads, one head
    per group."""
    if x.dim() != 3 or Bm.dim() != 3 or dt.dim() != 2:
        raise ValueError(f"expected x (BH,S,P), dt (BH,S), Bm = Cm (BH,S,N); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(Bm.shape)}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)

    def model(t):        # (BH, S, ...) as one batch of BH heads: a view
        return t.transpose(0, 1).unsqueeze(0)

    _, hT = ssd_grouped(model(x), model(dt), A, model(Bm), model(Cm),
                        chunk=chunk, out=model(y))
    return y, hT[0]
