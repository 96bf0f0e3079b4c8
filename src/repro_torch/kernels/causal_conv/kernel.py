"""The Mamba-2 mixer's causal depthwise conv with its SiLU, forward and
backward: the hand-written Hopper kernels' wrappers
(``csrc/causal_conv.cu``, built by ``kernels._build`` at first use; see its
header for the design).

x (B, S, C), float32 or bfloat16, is read in place at its batch and row
strides with a unit last stride, as the column slice of in_proj's output
the mixer hands over; taps w (K, C) with K at most 4 and bias b (C,), of
one dtype, float32 or bfloat16, are read as float32 and rounded to x's
dtype, as the plain expression rounds them. The output, dx and dy are
contiguous (B, S, C) in x's dtype; dw and db are float32. Where a base, a
stride or C does not suit 16-byte accesses, the kernels copy element by
element between device and shared memory.

For a CUDA tensor a wrapper launches the kernels on the current stream or
raises; no input is copied, and an operand the kernel cannot read (last
stride not 1, K above 4, dtypes that differ) is refused. For a ``meta``
tensor it allocates what the card would and computes nothing. On both it
reports the call to ``kernels.record_call``, as ``"causal_conv"`` with
operands (x, w, b) and result (y), and as ``"causal_conv_bwd"`` with
operands (x, w, b, dy) and results (dx, dw, db), which
``telemetry.LaunchCounter`` counts (a call on ``meta`` launches nothing).
The plain versions are ``ref.causal_conv_silu_ref`` and
``ref.causal_conv_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, no_grad_inputs, record_call

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 4
# the kernels' geometry (``causal_conv_geometry``): rows a backward tile,
# bytes of a row's channels a tile, backward blocks an SM holds
BWD_TILE_ROWS, TILE_BYTES, BWD_BLOCKS_PER_SM = 64, 128, 4
# the backward's grid is one wave of resident blocks on an H100's 132 SMs
BWD_RESIDENT = 132 * BWD_BLOCKS_PER_SM


@functools.cache
def _lib():
    lib = _build.load("causal_conv")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.causal_conv_fwd.argtypes = [vp, ll, ll, vp, vp, vp, i, i, i, i, i,
                                    vp]
    lib.causal_conv_fwd.restype = i
    lib.causal_conv_bwd.argtypes = [vp, ll, ll, vp, vp, vp, vp, vp, vp, i,
                                    i, i, i, i, i, vp]
    lib.causal_conv_bwd.restype = i
    lib.causal_conv_geometry.argtypes = [i]
    lib.causal_conv_geometry.restype = i
    lib.causal_conv_error_string.argtypes = [i]
    lib.causal_conv_error_string.restype = ctypes.c_char_p
    geometry = [lib.causal_conv_geometry(n) for n in range(3)]
    if geometry != [BWD_TILE_ROWS, TILE_BYTES, BWD_BLOCKS_PER_SM]:
        raise RuntimeError(f"csrc/causal_conv.cu's geometry {geometry} is "
                           f"not {[BWD_TILE_ROWS, TILE_BYTES]} and "
                           f"{BWD_BLOCKS_PER_SM} blocks an SM")
    return lib


def bwd_rows(B: int, S: int, C: int, dtype) -> int:
    """The backward's blocks down the rows, each a row of (K + 1) C f32
    partials: as many as fill one wave of resident blocks beside the
    blocks across the channels, and no more than the tiles of rows."""
    tiles = B * -(-S // BWD_TILE_ROWS)
    across = -(-C // (TILE_BYTES // dtype.itemsize))
    return max(1, min(tiles, BWD_RESIDENT // across))


def _check(x, w, b):
    if x.dim() != 3 or w.dim() != 2 or w.shape[1:] != x.shape[2:] \
            or b.shape != x.shape[2:] or not 1 <= w.shape[0] <= MAX_TAPS:
        raise ValueError(f"expected x (B, S, C), w (K, C) with K at most "
                         f"{MAX_TAPS}, b (C,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES \
            or b.dtype != w.dtype:
        raise TypeError(f"x must be float32 or bfloat16, w and b share "
                        f"float32 or bfloat16; got {x.dtype}, {w.dtype}, "
                        f"{b.dtype}")
    if len({t.device for t in (x, w, b)}) != 1:
        raise ValueError("the inputs are on different devices")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no causal conv kernel for device {x.device}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"x needs a unit last stride; got strides "
                         f"{x.stride()}")
    return w.shape[0]


def _call(fn: str, *args):
    lib = _lib()
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.causal_conv_error_string(err).decode())


def causal_conv_fwd(x, w, b):
    """y = silu(causal depthwise conv of x with taps w and bias b), (B, S,
    C) contiguous in x's dtype. Raises for an input that requires grad in
    grad mode (the Function in ``ops`` carries the gradient)."""
    K = _check(x, w, b)
    no_grad_inputs("causal_conv_fwd", x, w, b)
    B_, S, C = x.shape
    y = torch.empty((B_, S, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    w32, b32 = w.float().contiguous(), b.float().contiguous()
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            _call("causal_conv_fwd", x.data_ptr(), x.stride(0), x.stride(1),
                  w32.data_ptr(), b32.data_ptr(), y.data_ptr(), B_, S, C, K,
                  _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    record_call("causal_conv", (x, w, b), (y,))
    return y


def causal_conv_bwd(x, w, b, dy):
    """The gradients (dx (B, S, C) contiguous in x's dtype, dw (K, C) and
    db (C,) float32) from dy, contiguous (B, S, C) in x's dtype, and the
    forward's inputs."""
    K = _check(x, w, b)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous and match x: "
                         f"{tuple(dy.shape)} {dy.dtype} {dy.device}")
    no_grad_inputs("causal_conv_bwd", x, w, b, dy)
    B_, S, C = x.shape
    dev = x.device
    dx = torch.empty((B_, S, C), dtype=x.dtype, device=dev)
    red = torch.empty(((K + 1) * C,), dtype=torch.float32, device=dev)
    dw, db = red[:K * C].view(K, C), red[K * C:]
    if dx.numel() == 0:
        red.zero_()         # sums over no row
        return dx, dw, db
    nrow = bwd_rows(B_, S, C, x.dtype)
    part = torch.empty((nrow, (K + 1) * C), dtype=torch.float32, device=dev)
    w32, b32 = w.float().contiguous(), b.float().contiguous()
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            _call("causal_conv_bwd", x.data_ptr(), x.stride(0), x.stride(1),
                  w32.data_ptr(), b32.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), red.data_ptr(), B_, S, C,
                  K, nrow, _DTYPES[x.dtype],
                  torch.cuda.current_stream(dev).cuda_stream)
    record_call("causal_conv_bwd", (x, w, b, dy), (dx, dw, db))
    return dx, dw, db
