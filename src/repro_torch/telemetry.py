"""Shared JSONL trace-record schema for simulation AND deployment traces
(the port's copy of ``repro.telemetry``: NumPy and json, the same lines).

One schema, two producers: ``sim.engine.SimEngine`` emits per-round
records of the *simulated* run (predicted wireless latency, planned
clusters, network snapshot), and the reference's ``rt`` runtime emits the
same round records for *executed* rounds (measured wall-clock in
``wall_s``) plus per-device ``QoSRecord`` phase timings. Because both carry the
``v / clusters / xs / f / rate`` snapshot keys,
``sim.engine.recompute_trace_latencies`` prices either trace with the
eq. 15-25 cost model — which is what lets ``rt.crossval`` put measured
and predicted round latency side by side on the identical scenario.

Records are plain dicts on the wire (JSONL); the dataclasses here are
the typed view — ``from_dict`` parses any producer's record (unknown
keys land in ``extras``), and ``to_dict`` emits exactly the non-None
fields, so parse -> emit is the identity on schema-conforming records
(tests/test_torch_sim.py pins the roundtrip and the lines against the
reference's).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np


def jsonable(o):
    """Recursively convert numpy / torch leaves to JSON-serializable
    builtins."""
    if hasattr(o, "detach") and hasattr(o, "cpu"):     # torch tensors
        o = o.detach().cpu().numpy()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "__array__") and not isinstance(o, (str, bytes)):
        return jsonable(np.asarray(o))   # other array types
    if isinstance(o, (list, tuple)):
        return [jsonable(x) for x in o]
    if isinstance(o, dict):
        return {k: jsonable(v) for k, v in o.items()}
    return o


def _field_names(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)} - {"extras"}


class _Record:
    """to_dict/from_dict shared by the record dataclasses: emit declared
    non-None fields in order, park unknown keys in ``extras``."""

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            if f.name == "extras":
                continue
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        out.update(self.extras)
        return jsonable(out)

    @classmethod
    def from_dict(cls, d: dict):
        known = _field_names(cls)
        kw = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        return cls(**kw, extras=extras)


@dataclass
class RoundRecord(_Record):
    """One executed (or skipped) round. ``latency_s`` is the cost-model
    *prediction* (sim producer); ``wall_s`` is the *measured* wall-clock
    (rt producer) — a record may carry either or both. ``clusters`` are
    local indices into the ``f``/``rate`` snapshot arrays, which is the
    layout ``recompute_trace_latencies`` reprices."""
    round: int
    skipped: Optional[str] = None
    v: Optional[int] = None
    stale: Optional[bool] = None
    n_active: Optional[int] = None
    ids: Optional[Any] = None
    f: Optional[Any] = None
    rate: Optional[Any] = None
    clusters: Optional[Any] = None
    clusters_global: Optional[Any] = None
    xs: Optional[Any] = None
    planned_latency_s: Optional[float] = None
    latency_s: Optional[float] = None
    sim_time_s: Optional[float] = None
    wall_s: Optional[float] = None
    cut_means: Optional[Any] = None
    loss: Optional[float] = None
    eval: Optional[Any] = None
    dropped: Optional[List[int]] = None
    recovered: Optional[List[int]] = None  # rt: died mid-cluster, came
                                           # back via lossless retry
    source: Optional[str] = None          # "sim" | "rt"
    events: Optional[List[dict]] = None
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class QoSRecord(_Record):
    """One measured phase on one device (rt producer). ``phase`` is one
    of fwd | upload | grad_wait | bwd | model_up | server | round;
    ``device`` is the global device id (-1 = the server itself)."""
    round: int
    device: int
    phase: str
    t_s: float
    kind: str = "qos"
    cluster: Optional[int] = None
    epoch: Optional[int] = None
    slot: Optional[int] = None
    attempt: Optional[int] = None
    bytes: Optional[int] = None
    ok: Optional[bool] = None
    extras: Dict[str, Any] = field(default_factory=dict)


def parse_record(d: dict) -> Union[RoundRecord, QoSRecord]:
    """Typed view of a trace line from either producer."""
    if d.get("kind") == "qos":
        return QoSRecord.from_dict(d)
    return RoundRecord.from_dict(d)


class TraceWriter:
    """Append-only JSONL sink + in-memory record list. ``path=None``
    keeps records in memory only; ``fresh=True`` truncates an existing
    file (stale rounds would interleave into downstream recompute).

    ``fsync=True`` makes every emit durable (flush + ``os.fsync``)
    before returning — the rt server runs its trace in this mode so a
    SIGKILL can tear at most the line being written, never lose a
    committed round. The torn final line is ``load_trace``'s problem.
    """

    def __init__(self, path: Optional[str] = None, fresh: bool = True,
                 fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self.records: List[dict] = []
        if path and fresh:
            open(path, "w").close()

    def emit(self, rec) -> dict:
        d = rec.to_dict() if isinstance(rec, _Record) else jsonable(rec)
        self.records.append(d)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(d) + "\n")
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
        return d

    def rewrite(self, records: List[dict]):
        """Atomically replace the file (and in-memory list) with
        ``records`` — the resume path uses this to truncate a crashed
        run's trace back to its last committed round."""
        self.records = list(records)
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for d in self.records:
                    f.write(json.dumps(d) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)


def load_trace(path: str, tolerate_torn_tail: bool = True) -> List[dict]:
    """Parse a JSONL trace. A process killed mid-write leaves a torn
    *final* line (no trailing newline / truncated JSON); with
    ``tolerate_torn_tail`` that line is dropped with a warning instead
    of raising, because every earlier line was complete when it was
    appended. A malformed line anywhere *else* is real corruption and
    still raises."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    out = []
    for i, line in enumerate(lines):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if tolerate_torn_tail and i == len(lines) - 1:
                warnings.warn(
                    f"{path}: dropping torn final trace line "
                    f"({len(line)} bytes): {e}", RuntimeWarning)
                break
            raise ValueError(
                f"{path}: corrupt trace line {i + 1} of {len(lines)}: {e}"
            ) from e
    return out
