"""The msgpack the port writes and reads, with code of its own: byte for
byte what ``msgpack.packb(obj, use_bin_type=True)`` gives, for the types
the port's two formats carry.

- The checkpoint format (``checkpoint.checkpointer``) is maps, arrays,
  str, bin and ints. It packs and reads with ``strict=True``, which
  refuses anything else.
- The runtime's wire format (``rt.protocol``) adds nil, bools and Python
  floats (packed as float64, as msgpack does by default); it reads
  float32 too.

The port does not depend on the ``msgpack`` package; the tests hold this
module to it.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

def _refuse(what: str, strict: bool) -> str:
    fmt = "the checkpoint format" if strict else "the wire format"
    return f"{what} is not in {fmt}"


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int,
              codes) -> None:
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, hi in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                              (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if n < hi:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, lo in ((0xd0, ">Bb", -(1 << 7)),
                              (0xd1, ">Bh", -(1 << 15)),
                              (0xd2, ">Bi", -(1 << 31)),
                              (0xd3, ">Bq", -(1 << 63))):
            if n >= lo:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)


def _pack(out: bytearray, obj, strict: bool) -> None:
    if obj is None or isinstance(obj, (bool, float)):
        if strict:
            raise TypeError(_refuse(repr(obj), strict))
        if obj is None:
            out.append(0xc0)
        elif isinstance(obj, bool):
            out.append(0xc3 if obj else 0xc2)
        else:
            out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v, strict)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    else:
        raise TypeError(_refuse(str(type(obj)), strict))


def packb(obj, strict: bool = False) -> bytes:
    """msgpack bytes of ``obj``, as ``msgpack.packb(obj,
    use_bin_type=True)`` gives them (tuples pack as arrays)."""
    out = bytearray()
    _pack(out, obj, strict)
    return bytes(out)


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SCALARS = {0xc0: None, 0xc2: False, 0xc3: True}
_FLOATS = {0xca: ">f", 0xcb: ">d"}
_LENS = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
         0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
         0xde: ">H", 0xdf: ">I"}


def unpackb(raw: bytes, strict: bool = False):
    """Inverse of ``packb`` (arrays come back as lists, maps as dicts with
    keys of any type); raises ``ValueError`` on truncated or trailing
    bytes and on a type outside the format."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(raw):
            raise ValueError("truncated msgpack data")
        b = raw[pos:pos + n]
        pos += n
        return b

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def one():
        c = take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c < 0x90:
            return {one(): one() for _ in range(c & 0x0f)}
        if 0x90 <= c < 0xa0:
            return [one() for _ in range(c & 0x0f)]
        if 0xa0 <= c < 0xc0:
            return take(c & 0x1f).decode("utf-8")
        if c in _INTS:
            return num(_INTS[c])
        if not strict and c in _SCALARS:
            return _SCALARS[c]
        if not strict and c in _FLOATS:
            return num(_FLOATS[c])
        if c not in _LENS:
            raise ValueError(_refuse(f"msgpack type 0x{c:02x}", strict))
        n = num(_LENS[c])
        if c in (0xc4, 0xc5, 0xc6):
            return take(n)
        if c in (0xd9, 0xda, 0xdb):
            return take(n).decode("utf-8")
        if c in (0xdc, 0xdd):
            return [one() for _ in range(n)]
        return {one(): one() for _ in range(n)}

    obj = one()
    if pos != len(raw):
        raise ValueError(f"{len(raw) - pos} trailing bytes")
    return obj


# --------------------------------------------------------------------------
# arrays as {"dtype", "shape", "data"} records (both formats)
# --------------------------------------------------------------------------

def tensor_record(t) -> dict:
    """``{"dtype", "shape", "data"}`` of a tensor on any device, dtype by
    NAME as the reference stores it; bfloat16, which numpy lacks, travels
    as ``"bfloat16"`` through an int16 view of its bytes."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, a = "bfloat16", t.view(torch.int16).numpy()
    else:
        a = t.numpy()
        name = a.dtype.name
    return {"dtype": name, "shape": list(t.shape), "data": a.tobytes()}


def record_array(d: dict):
    """The array of a record: a writable numpy array, or a CPU
    ``torch.Tensor`` for bfloat16 (numpy has no bfloat16 of its own)."""
    shape = [int(s) for s in d["shape"]]
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(d["data"], dtype=np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])) \
        .reshape(shape).copy()
