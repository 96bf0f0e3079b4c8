"""Wire format for the CPSL deployment runtime (the port of
``repro.rt.protocol``; frames are byte-identical to the reference's for
numpy payloads, so each side decodes the other's).

Frames are length-prefixed msgpack:

    +-------+---------+----------+-----+-------------------+
    | magic | version | msg type | pad | body length (u32) |  8-byte header
    +-------+---------+----------+-----+-------------------+
    |                msgpack-encoded payload               |
    +------------------------------------------------------+

The payload codec round-trips the trees the CPSL protocol actually ships
(device/optimizer params, smashed activations, cut-layer gradients)
exactly:

  * numpy arrays and torch tensors (on any device: moved to host bytes)
    -> ``{"__nd__": {dtype-name, shape, raw bytes}}``; 0-d arrays keep
    shape ``[]``. bfloat16, which numpy lacks, travels as ``"bfloat16"``
    through an int16 view and decodes to a CPU ``torch.Tensor``; every
    numpy dtype decodes to a writable numpy array. Anything else exposing
    ``__array__`` (numpy scalars) is materialised to host numpy first.
  * tuples -> ``{"__tuple__": [...]}``: msgpack would decode them as
    lists, but optimizer states are tuples (sgd's is the empty tuple) and
    tree *structure* must survive the wire for the bit-exactness contract.

The msgpack itself is the port's own (``repro_torch.codec``): the port
does not depend on the ``msgpack`` package.

Errors: ``BadMagic`` (the peer is not speaking this protocol at all),
``VersionMismatch`` (right protocol, wrong revision: carries
``peer_version``/``our_version`` and names both in the message),
``BadFrame`` (unknown message type / malformed payload),
``TruncatedFrame`` (EOF or stall mid-frame), ``ConnectionClosed`` (clean
EOF between frames). All derive from ``ProtocolError``.
"""
from __future__ import annotations

import enum
import struct
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import codec

MAGIC = 0xC5
VERSION = 1
HEADER = struct.Struct(">BBBxI")   # magic, version, msg type, pad, length
MAX_FRAME = 1 << 30                # sanity bound: 1 GiB


class MsgType(enum.IntEnum):
    REGISTER = 1       # device -> server: {device}
    PLAN = 2           # server -> device: static run parameters
    CLUSTER_START = 3  # server -> device: {round, m, k, members, dev,
                       #                    dev_opt, step}
    SMASHED = 4        # device -> server: {round, m, epoch, k, smashed}
    GRAD = 5           # server -> device: {round, m, epoch, g}
    AGG = 6            # device -> server: {round, m, k, dev, dev_opt, qos}
    AGG_ACK = 7        # server -> device: {round, m}
    HEARTBEAT = 8      # device -> server: {device, t}
    SHUTDOWN = 9       # server -> device: {}
    BYE = 10           # device -> server: {device}
    ERROR = 11         # server -> device: {reason} (e.g. dropped straggler)
    READY = 12         # device -> server: warm-up done, {device}
    REJOIN = 13        # device -> server: already-built worker reconnecting
                       #                   after a server restart, {device}
    REJOIN_ACK = 14    # server -> device: {round, step}: the committed
                       #                   round/step counters the resumed
                       #                   run continues from (device
                       #                   params ride CLUSTER_START as
                       #                   always: workers are stateless
                       #                   between clusters by design)


class ProtocolError(RuntimeError):
    pass


class VersionMismatch(ProtocolError):
    """The peer frames this protocol but at a different revision;
    ``peer_version`` / ``our_version`` are attributes and both are named
    in the message."""

    def __init__(self, peer_version: int, our_version: int):
        self.peer_version = int(peer_version)
        self.our_version = int(our_version)
        newer = self.peer_version > self.our_version
        super().__init__(
            f"protocol version mismatch: peer speaks v{peer_version}, "
            f"we speak v{our_version} — upgrade "
            f"{'this side' if newer else 'the peer'} so both ends run "
            f"the same repro.rt revision")


class BadMagic(VersionMismatch):
    """Wrong magic byte: the peer is not speaking this protocol at all (or
    the stream desynchronized). Subclasses ``VersionMismatch`` so its
    handlers catch it too."""

    def __init__(self, magic: int):
        self.magic = int(magic)
        ProtocolError.__init__(
            self, f"bad magic 0x{magic:02x} (expected 0x{MAGIC:02x}): "
                  f"peer is not a repro.rt endpoint")


class BadFrame(ProtocolError):
    pass


class TruncatedFrame(ProtocolError):
    pass


class ConnectionClosed(ProtocolError):
    pass


# -- payload codec -----------------------------------------------------------

def _enc(o: Any) -> Any:
    if isinstance(o, np.ndarray):
        shape = list(o.shape)          # before ascontiguousarray: it
        a = np.ascontiguousarray(o)    # promotes 0-d -> (1,)
        return {"__nd__": {"dtype": a.dtype.name, "shape": shape,
                           "data": a.tobytes()}}
    if isinstance(o, torch.Tensor):
        return {"__nd__": codec.tensor_record(o)}
    if isinstance(o, np.generic):      # numpy scalar: keep its dtype
        return _enc(np.asarray(o))
    if isinstance(o, tuple):
        return {"__tuple__": [_enc(x) for x in o]}
    if isinstance(o, list):
        return [_enc(x) for x in o]
    if isinstance(o, dict):
        return {k: _enc(v) for k, v in o.items()}
    if hasattr(o, "__array__") and not isinstance(o, (str, bytes)):
        return _enc(np.asarray(o))
    return o


def _dec(o: Any) -> Any:
    if isinstance(o, dict):
        if "__nd__" in o and len(o) == 1:
            return codec.record_array(o["__nd__"])
        if "__tuple__" in o and len(o) == 1:
            return tuple(_dec(x) for x in o["__tuple__"])
        return {k: _dec(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_dec(x) for x in o]
    return o


def encode_payload(obj: Any) -> bytes:
    return codec.packb(_enc(obj))


def decode_payload(raw: bytes) -> Any:
    try:
        return _dec(codec.unpackb(raw))
    except (ValueError, KeyError, TypeError, RecursionError) as e:
        # malformed msgpack, or an array record missing or garbling a field
        raise BadFrame(f"undecodable payload: {e}") from e


# -- framing -----------------------------------------------------------------

def frame(mtype: MsgType, payload: Any) -> bytes:
    body = encode_payload(payload)
    return HEADER.pack(MAGIC, VERSION, int(mtype), len(body)) + body


def parse_header(hdr: bytes) -> Tuple[MsgType, int]:
    if len(hdr) != HEADER.size:
        raise TruncatedFrame(f"short header: {len(hdr)} bytes")
    magic, version, mtype, length = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise BadMagic(magic)
    if version != VERSION:
        raise VersionMismatch(peer_version=version, our_version=VERSION)
    if length > MAX_FRAME:
        raise BadFrame(f"frame of {length} bytes exceeds cap {MAX_FRAME}")
    try:
        return MsgType(mtype), length
    except ValueError as e:
        raise BadFrame(f"unknown message type {mtype}") from e


def unpack_frame(buf: bytes) -> Tuple[MsgType, Any]:
    """Parse one complete frame from a byte string (tests / in-memory
    transports; sockets use ``transport.Channel``, which reads the header
    and body incrementally)."""
    mtype, length = parse_header(buf[:HEADER.size])
    body = buf[HEADER.size:]
    if len(body) < length:
        raise TruncatedFrame(f"body has {len(body)} of {length} bytes")
    return mtype, decode_payload(body[:length])
