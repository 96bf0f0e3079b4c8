"""The Mamba-2 mixer's gated output stage, forward and backward: the
hand-written Hopper kernels' wrappers (``csrc/gated_norm.cu``, built by
``kernels._build`` at first use; see its header for the design).

Rows of width W = H P: y (the SSD's output) and x (the skip's input) per
head, (..., H, P), and z (the gate) (..., W), of one dtype, float32 or
bfloat16, each flattening to rows as a view: a row stride and a unit last
stride, as the column slices of the packed projections the mixer has are.
D (H,) and the norm's scale (W,) may be float32 or bfloat16; the kernels
read them as float32 and round D to the rows' dtype, as the plain
expression does. The output, and dz, take z's shape; dy and dx y's.

For a CUDA tensor a wrapper launches the kernels on the current stream or
raises; no input is copied, and an operand the kernel cannot read (last
stride not 1, a row or base not 16-byte aligned, leading dims that do not
flatten) is refused. For a ``meta`` tensor it allocates what the card would
and computes nothing. On both it reports the call to
``kernels.record_call``, as ``"gated_norm"`` with operands (y, x, z, D,
scale) and results (out, rstd), and as ``"gated_norm_bwd"`` with operands
(y, x, z, D, scale, rstd, dout) and results (dy, dx, dz, dD, dscale), which
``telemetry.LaunchCounter`` counts (a call on ``meta`` launches nothing).
The plain versions are ``ref.gated_norm_ref`` and
``ref.gated_norm_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, no_grad_inputs, record_call

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROWS = 64      # rows a backward block walks (a row of partials each)


@functools.cache
def _lib():
    lib = _build.load("gated_norm")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gated_norm_fwd.argtypes = [vp, vp, vp, ll, ll, ll, vp, vp, vp, vp,
                                   i, i, i, ctypes.c_float, i, vp]
    lib.gated_norm_fwd.restype = i
    lib.gated_norm_bwd.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp, vp,
                                   vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.gated_norm_bwd.restype = i
    lib.gated_norm_error_string.argtypes = [i]
    lib.gated_norm_error_string.restype = ctypes.c_char_p
    return lib


def bwd_blocks(rows: int) -> int:
    """The backward's blocks, each a row of W + H f32 partials."""
    return max(1, -(-rows // BWD_ROWS))


def _check(y, x, z, D, scale):
    if y.dim() < 2 or x.shape != y.shape:
        raise ValueError(f"y and x must share a shape (..., H, P); got "
                         f"{tuple(y.shape)}, {tuple(x.shape)}")
    H, P = y.shape[-2:]
    W = H * P
    if z.shape != (*y.shape[:-2], W) or D.shape != (H,) \
            or scale.shape != (W,) or P % 8 or H == 0:
        raise ValueError(f"expected y, x (..., H, P) with P a multiple of "
                         f"8, z (..., H P), D (H,), scale (H P,); got "
                         f"{tuple(y.shape)}, {tuple(z.shape)}, "
                         f"{tuple(D.shape)}, {tuple(scale.shape)}")
    if not (y.dtype == x.dtype == z.dtype) or y.dtype not in _DTYPES:
        raise TypeError(f"y, x, z must share float32 or bfloat16; got "
                        f"{y.dtype}, {x.dtype}, {z.dtype}")
    if D.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"D and scale must be float32 or bfloat16; got "
                        f"{D.dtype}, {scale.dtype}")
    if len({t.device for t in (y, x, z, D, scale)}) != 1:
        raise ValueError("the inputs are on different devices")
    if y.device.type not in ("cuda", "meta"):
        raise ValueError(f"no gated norm kernel for device {y.device}")
    return H, P


def _rows(t, W: int, name: str):
    """t as (rows, W), a view read by 16-byte loads: unit last stride,
    base and row stride 16-byte aligned."""
    try:
        r = t.view(-1, W)
    except RuntimeError:
        raise ValueError(f"{name}: the leading dims of a {tuple(t.shape)} "
                         f"tensor with strides {t.stride()} do not flatten "
                         f"to rows") from None
    e = r.element_size()
    if (r.stride(-1) != 1 or r.data_ptr() % 16
            or (r.shape[0] > 1 and r.stride(0) * e % 16)):
        raise ValueError(f"{name} needs 16-byte aligned rows: last stride "
                         f"1, base and row stride a multiple of 16 bytes; "
                         f"got strides {t.stride()}")
    return r


def _aligned_f32(t):
    """t as contiguous f32 read by 16-byte loads (a copy where a view's
    base is not 16-byte aligned)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _call(fn: str, *args):
    lib = _lib()
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.gated_norm_error_string(err).decode())


def gated_norm_fwd(y, x, z, D, scale, eps: float):
    """(out (z's shape, y's dtype), rstd (rows,) f32): out = rmsnorm((y +
    D x) silu(z)) scale, rstd each row's 1 / sqrt(mean(g^2) + eps). Raises
    for an input that requires grad in grad mode (the Function in ``ops``
    carries the gradient)."""
    H, P = _check(y, x, z, D, scale)
    no_grad_inputs("gated_norm_fwd", y, x, z, D, scale)
    rows = [_rows(t, H * P, n) for t, n in ((y, "y"), (x, "x"), (z, "z"))]
    R, W = rows[0].shape
    dev = y.device
    out = torch.empty(z.shape, dtype=y.dtype, device=dev)
    rstd = torch.empty((R,), dtype=torch.float32, device=dev)
    if R == 0:
        return out, rstd
    D32, s32 = D.float().contiguous(), _aligned_f32(scale)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            _call("gated_norm_fwd", *(t.data_ptr() for t in rows),
                  *(t.stride(0) for t in rows), D32.data_ptr(),
                  s32.data_ptr(), out.data_ptr(), rstd.data_ptr(), R, W,
                  P, float(eps), _DTYPES[y.dtype],
                  torch.cuda.current_stream(dev).cuda_stream)
    record_call("gated_norm", (y, x, z, D, scale), (out, rstd))
    return out, rstd


def gated_norm_bwd(y, x, z, D, scale, rstd, dout):
    """The gradients (dy, dx in y's shape, dz in z's, all in y's dtype; dD
    (H,) and dscale (W,) f32) from dout (z's shape, y's dtype) and the
    forward's inputs and rstd. dout, like y, x and z, is read at its
    strides and needs 16-byte aligned rows."""
    H, P = _check(y, x, z, D, scale)
    if dout.shape != z.shape or dout.dtype != y.dtype \
            or dout.device != y.device:
        raise ValueError(f"dout must match z: {tuple(dout.shape)} "
                         f"{dout.dtype} {dout.device}")
    rows = [_rows(t, H * P, n) for t, n in ((y, "y"), (x, "x"), (z, "z"))]
    R, W = rows[0].shape
    if rstd.shape != (R,) or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be ({R},) float32; got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    no_grad_inputs("gated_norm_bwd", y, x, z, D, scale, rstd, dout)
    d2 = _rows(dout, W, "dout")
    dev = y.device
    grads = [torch.empty(t.shape, dtype=y.dtype, device=dev)
             for t in (y, y, z)]
    red = torch.empty((W + H,), dtype=torch.float32, device=dev)
    dscale, dD = red[:W], red[W:]
    if R == 0:
        red.zero_()         # sums over no row
        return (*grads, dD, dscale)
    nblk = bwd_blocks(R)
    part = torch.empty((nblk, W + H), dtype=torch.float32, device=dev)
    D32, s32 = D.float().contiguous(), _aligned_f32(scale)
    rstd = rstd.contiguous()
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            _call("gated_norm_bwd", *(t.data_ptr() for t in rows),
                  d2.data_ptr(), *(t.stride(0) for t in rows), d2.stride(0),
                  D32.data_ptr(), s32.data_ptr(), rstd.data_ptr(),
                  *(g.data_ptr() for g in grads), part.data_ptr(),
                  red.data_ptr(), R, W, P, nblk, _DTYPES[y.dtype],
                  torch.cuda.current_stream(dev).cuda_stream)
    record_call("gated_norm_bwd", (y, x, z, D, scale, rstd, dout),
                (*grads, dD, dscale))
    return (*grads, dD, dscale)
