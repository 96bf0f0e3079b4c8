"""Fault-tolerant checkpointing (the port of
``repro.checkpoint.checkpointer``): msgpack payloads compressed with zlib,
atomic renames, an async save thread, keep-k GC, per-file integrity
checksums, and restore onto whatever device the target tree lives on.

The file format is the reference's, so a checkpoint written by either
package restores in the other: ``b"RCK1" + crc32(payload) + payload``,
where the payload is a compressed msgpack map from each leaf's path string
(keys and indices joined by ``/``, in ``jax.tree`` flatten order) to
``{"dtype": name, "shape": [...], "data": raw bytes}``. The port writes
and reads the msgpack subset the format uses (maps, str, bin, arrays and
ints) with its own codec (``repro_torch.codec``, strict), byte for byte
what ``msgpack.packb(..., use_bin_type=True)`` gives. It compresses with zlib, the reference's own
codec when ``zstandard`` is absent, and reads the reference's zstd files
where ``zstandard`` is installed.

A latest checkpoint that is corrupted or truncated makes
``restore(step=None)`` fall back to the previous keep-k entry with a
``CheckpointCorrupt`` warning; an explicit ``step=`` still raises.
Unframed legacy files are read without verification.
"""
from __future__ import annotations

import os
import re
import struct
import threading
import warnings
import zlib
from typing import Any, Optional

import torch

from repro_torch import codec, tree

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_CKPT_MAGIC = b"RCK1"              # framed: magic + u32 crc32 + payload
_CKPT_HDR = struct.Struct(">4sI")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file failed its integrity check (bad checksum,
    truncated header, undecodable payload)."""


def frame_blob(payload: bytes) -> bytes:
    return _CKPT_HDR.pack(_CKPT_MAGIC, zlib.crc32(payload)) + payload


def unframe_blob(blob: bytes, name: str = "checkpoint") -> bytes:
    """Verify and strip the integrity frame. Unframed (legacy) blobs
    pass through unverified; framed blobs with a wrong checksum or a
    truncated body raise ``CheckpointCorrupt``."""
    if blob[:4] != _CKPT_MAGIC:
        return blob
    if len(blob) < _CKPT_HDR.size:
        raise CheckpointCorrupt(f"{name}: truncated header "
                                f"({len(blob)} bytes)")
    _, crc = _CKPT_HDR.unpack(blob[:_CKPT_HDR.size])
    payload = blob[_CKPT_HDR.size:]
    got = zlib.crc32(payload)
    if got != crc:
        raise CheckpointCorrupt(
            f"{name}: checksum mismatch (stored 0x{crc:08x}, computed "
            f"0x{got:08x}) — file is corrupted or torn")
    return payload


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes and ints), as
    ``msgpack.packb(obj, use_bin_type=True)`` gives them; any other type
    raises ``TypeError``."""
    return codec.packb(obj, strict=True)


def unpackb(raw: bytes):
    """Inverse of ``packb``; raises ``ValueError`` on anything else."""
    return codec.unpackb(raw, strict=True)


# --------------------------------------------------------------------------
# trees of tensors <-> payload
# --------------------------------------------------------------------------

def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def payload_bytes(state) -> bytes:
    """The uncompressed msgpack payload of a tree of tensors."""
    return packb({_path_str(path): codec.tensor_record(leaf)
                  for path, leaf in tree.flatten_with_path(state)})


def serialize(state) -> bytes:
    return zlib.compress(payload_bytes(state), 6)


def _decompress(blob: bytes) -> bytes:
    if blob[:4] != _ZSTD_MAGIC:
        return zlib.decompress(blob)
    try:        # the reference writes zstd where zstandard is installed
        import zstandard
    except ImportError:
        raise RuntimeError("checkpoint is zstd-compressed but the "
                           "zstandard package is not installed") from None
    return zstandard.ZstdDecompressor().decompress(blob)


def deserialize(blob: bytes, target) -> Any:
    """The tree of ``target`` with each leaf read from ``blob``, cast to
    the target leaf's dtype and placed on its device."""
    payload = unpackb(_decompress(blob))
    out = []
    for path, leaf in tree.flatten_with_path(target):
        key = _path_str(path)
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = torch.as_tensor(codec.record_array(payload[key]))
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        out.append(t)
    return tree.unflatten_like(target, out)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.restored_step: Optional[int] = None  # set by restore(step=None)
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def _write(self, blob: bytes, step: int):
        final = os.path.join(self.dir, f"ckpt_{step:010d}")
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame_blob(blob))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def save(self, state, step: int, block: bool = True):
        blob = serialize(state)        # the copy to the host happens here
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(target=self._write,
                                            args=(blob, step), daemon=True)
            self._thread.start()
        else:
            self._write(blob, step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ---------------------------------------------------------------

    def steps(self):
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _load(self, target, step: int):
        """Load and verify one checkpoint file; every failure mode
        (truncation, bad checksum, undecodable payload) surfaces as
        ``CheckpointCorrupt``."""
        name = f"ckpt_{step:010d}"
        with open(os.path.join(self.dir, name), "rb") as f:
            blob = f.read()
        payload = unframe_blob(blob, name=name)
        try:
            return deserialize(payload, target)
        except (KeyError, RuntimeError):
            raise                      # structure mismatch / no zstandard
        except (ValueError, zlib.error, TypeError) as e:
            raise CheckpointCorrupt(f"{name}: undecodable payload: {e}") \
                from e

    def restore(self, target, step: Optional[int] = None):
        """Restore ``step`` (explicit steps fail loudly on corruption).
        With ``step=None``, walk back from the latest entry, skipping a
        corrupt one with a warning. Raises only when every entry is
        corrupt."""
        if step is not None:
            return self._load(target, step)
        steps = self.steps()
        if not steps:
            return None
        err: Optional[CheckpointCorrupt] = None
        for s in reversed(steps):
            try:
                out = self._load(target, s)
            except CheckpointCorrupt as e:
                warnings.warn(
                    f"{e}; falling back to the previous checkpoint",
                    RuntimeWarning)
                err = e
                continue
            self.restored_step = s
            return out
        raise CheckpointCorrupt(
            f"all {len(steps)} checkpoints in {self.dir} are corrupt"
        ) from err

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.dir, f"ckpt_{s:010d}"))
            except OSError:
                pass
