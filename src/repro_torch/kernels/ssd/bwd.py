"""Mamba-2 SSD chunked scan, backward: the hand-written Hopper kernel's
wrapper (``csrc/ssd_bwd.cu``, built by ``kernels._build`` at first use;
see its header for the design).

``ssd_bwd`` takes the forward's inputs in the model layout as
``kernel.ssd_grouped`` reads them (x (B, S, H, P) and dt (B, S, H) at any
strides, A (H,), B and C once per group (B, S, G, N)), the gradients of y
and of the final state (ghT may be None), and the forward's ``chunk``; it
returns (dx bf16, ddt f32, dA f32, dB bf16, dC bf16), dB and dC summed over
each group's heads. bf16 only: the float32 backward stays the plain
recompute (``ops.SSD``'s docstring says why).

For a CUDA tensor it launches the kernel on the current stream or raises.
For a ``meta`` tensor it allocates what the card would (the outputs and
the scratch, ``scratch_numel``) on ``meta`` and computes nothing. On both
it reports the call to ``kernels.record_call`` as ``"ssd_bwd"`` with
operands (x, dt, A, Bm, Cm, gy[, ghT]) and results (dx, ddt, dA, dB, dC),
which ``telemetry.LaunchCounter`` counts (a call on ``meta`` launches
nothing). Its plain version is ``ref.ssd_bwd_ref``, the same
decomposition in f32 PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, no_grad_inputs, record_call
from repro_torch.kernels.ssd.kernel import STATE_DIMS, chunk_len

TILE = 64                 # rows of the kernel's tiles
SLICE_HEADS = 8           # heads a key or query block sums dB or dC over


def bwd_chunk(S: int, Q: int) -> int:
    """The backward kernel's chunk: Q itself from a tile's 64 rows up;
    below that as many whole chunks as fill a tile, run together with the
    cumsum running on across them (which changes only the rounding, as the
    forward kernel's items of several whole chunks do)."""
    return Q if Q >= TILE else Q * (TILE // Q)


@functools.cache
def _lib():
    lib = _build.load("ssd_bwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_bwd.argtypes = [vp] * 22 + [i] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), vp]
    lib.ssd_bwd.restype = i
    lib.ssd_bwd_error_string.argtypes = [i]
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    return lib


def slice_heads(heads_per_group: int) -> int:
    """Heads a key or query block walks, summing dB or dC over them in its
    registers: the largest divisor of a group's heads up to SLICE_HEADS."""
    return max(d for d in range(1, SLICE_HEADS + 1) if heads_per_group % d
               == 0)


def scratch_numel(B_: int, S: int, H: int, G: int, N: int, P: int,
                  Q: int) -> dict:
    """The kernel's scratch at chunk Q (``chunk_len``'s result), by name,
    in f32 elements, in the order the kernel takes it (those it reads by
    16-byte copies first): each chunk's two state terms (B H nc P N each,
    f32), the states h and Dh as bf16 hi + lo planes (as many bytes), the
    head slices' partial dB and dC (B S (H / slice) N each), the cumsum and
    three per-row arrays (B H S each), and per-tile and per-chunk scalars
    (the scan splits a head's P N states among max(1, P N / 2048)
    blocks)."""
    Qc = bwd_chunk(S, Q)
    nc, nt = -(-S // Qc), -(-Qc // TILE)
    BH, nsl = B_ * H, H // slice_heads(H // G)
    state = BH * nc * P * N
    return {"hs": state, "ds": state, "hq": state, "dq": state,
            "pB": B_ * S * nsl * N, "pC": B_ * S * nsl * N, "cum": BH * S,
            "rows": 3 * BH * S, "dcl": BH * nc * nt,
            "dT": BH * nc * max(1, P * N // 2048)}


def scratch_bytes(B_: int, S: int, H: int, G: int, N: int, P: int,
                  Q: int) -> int:
    return 4 * sum(scratch_numel(B_, S, H, G, N, P, Q).values())


def _check(x, dt, A, Bm, Cm, gy, ghT):
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,S,H,P), Bm = Cm (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]
    if (Bm.shape[:2] != (B_, S) or dt.shape != (B_, S, H)
            or A.shape != (H,) or gy.shape != x.shape or G == 0 or H % G):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, gy {tuple(gy.shape)}")
    if ghT is not None and ghT.shape != (B_, H, N, P):
        raise ValueError(f"ghT must be (B,H,N,P) = {(B_, H, N, P)}; got "
                         f"{tuple(ghT.shape)}")
    if S == 0:
        raise ValueError("empty sequence")
    if any(t.dtype != torch.bfloat16 for t in (x, Bm, Cm, gy)):
        raise TypeError(f"x, Bm, Cm and gy must be bfloat16 (the float32 "
                        f"backward is the plain recompute); got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}, {gy.dtype}")
    if any(t is not None and t.dtype != torch.float32 for t in (dt, A, ghT)):
        raise TypeError("dt, A and ghT must be float32")
    devices = {t.device for t in (x, dt, A, Bm, Cm, gy, ghT) if t is not None}
    if len(devices) != 1:
        raise ValueError("the inputs are on different devices")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD backward kernel for device {x.device}")
    if N not in STATE_DIMS or P not in STATE_DIMS:
        raise ValueError(f"N={N}, P={P}: each must be in {STATE_DIMS}")


def _aligned(t) -> bool:
    """Read by 16-byte cp.async rows: contiguous last dim, 16-byte base and
    strides."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def ssd_bwd(x, dt, A, Bm, Cm, gy, ghT=None, *, chunk: int = 128):
    """The SSD's input gradients (dx, ddt, dA, dB, dC) from gy (the
    gradient of y, x's shape) and ghT (of the final state, (B, H, N, P)
    f32, or None), at the forward's ``chunk``. Raises for an input that
    requires grad in grad mode (the kernel has no backward of its own)."""
    _check(x, dt, A, Bm, Cm, gy, ghT)
    no_grad_inputs("ssd_bwd", *(t for t in (x, dt, A, Bm, Cm, gy, ghT)
                                if t is not None))
    if any(not _aligned(t) for t in (x, Bm, Cm)):
        raise ValueError("x, Bm, Cm need 16-byte aligned rows: the last dim "
                         "contiguous, base and strides a multiple of 8 "
                         "elements")
    if not _aligned(gy):
        gy = gy.contiguous()
    if ghT is not None:
        ghT = ghT.contiguous()
    A = A.contiguous()
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Q = chunk_len(S, chunk)
    dev = x.device
    dx = torch.empty((B_, S, H, P), dtype=torch.bfloat16, device=dev)
    ddt = torch.empty((B_, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((B_, S, G, N), dtype=torch.bfloat16, device=dev)
    dC = torch.empty((B_, S, G, N), dtype=torch.bfloat16, device=dev)
    outs = (dx, ddt, dA, dB, dC)
    ops = (x, dt, A, Bm, Cm, gy) + (() if ghT is None else (ghT,))
    if B_ * H == 0:
        dA.zero_()          # a sum over no batch
        return outs
    sizes = scratch_numel(B_, S, H, G, N, P, Q)
    scratch = torch.empty(sum(sizes.values()), dtype=torch.float32,
                          device=dev).split(list(sizes.values()))
    if dev.type == "meta":
        record_call("ssd_bwd", ops, outs)
        return outs
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *gy.stride()[:3])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), gy.data_ptr(),
            None if ghT is None else ghT.data_ptr(),
            *(t.data_ptr() for t in outs), *(t.data_ptr() for t in scratch),
            B_, S, H, G, bwd_chunk(S, Q), slice_heads(H // G), N, P, strides,
            stream)
    if err != 0:
        raise RuntimeError("ssd backward kernel launch failed: "
                           + lib.ssd_bwd_error_string(err).decode())
    record_call("ssd_bwd", ops, outs)
    return outs
