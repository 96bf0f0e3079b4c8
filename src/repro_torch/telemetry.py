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

The port's third producer is its own tracer (``span``, ``count``): spans
and counters at the layer boundaries of a CPSL round and of a serve call,
delivered to ``observers`` and kept as ``SpanRecord`` lines. Tracing is
on only while some observer takes spans or counters; off, ``span``
returns one shared no-op after a check of the observer list.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


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


@dataclass
class SpanRecord(_Record):
    """One closed span of the tracer. Host times are Unix-epoch ns
    (``time.time_ns``, the clock ``torch.profiler`` reports on); device
    times, where the span was timed on the card, are ms from its root's
    first CUDA event. ``parent`` is None for a root; ``counters`` are the
    totals counted while the span was the innermost open one."""
    name: str
    id: int
    root: int
    host_start_ns: int
    host_end_ns: int
    kind: str = "span"
    parent: Optional[int] = None
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None
    attrs: Optional[Dict[str, Any]] = None
    counters: Optional[Dict[str, Any]] = None
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms

    @property
    def seconds(self) -> float:
        """Device seconds where the span was timed on the card, else host
        seconds."""
        if self.device_start_ms is not None:
            return self.device_ms / 1e3
        return (self.host_end_ns - self.host_start_ns) / 1e9


def parse_record(d: dict) -> Union[RoundRecord, QoSRecord, SpanRecord]:
    """Typed view of a trace line from any producer."""
    if d.get("kind") == "qos":
        return QoSRecord.from_dict(d)
    if d.get("kind") == "span":
        return SpanRecord.from_dict(d)
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


# --------------------------------------------------------------------------
# observers: hand-kernel calls, spans and counters
# --------------------------------------------------------------------------

# Observers of the program (``launch.hlo_analysis.OpCounter`` and
# ``LaunchCounter`` add themselves while they count; a benchmark's record
# while it traces). An observer may have ``custom_call(name, operands,
# results)`` (each hand-kernel call: a launch through ctypes is no aten
# op, so each wrapper reports its kernel here, on the card and on its
# meta path), ``span(name, seconds)`` and ``count(name, n)``.
observers = []


def record_call(name: str, operands, results):
    """Report one kernel call (its operand and result tensors) to every
    observer that takes calls."""
    for obs in observers:
        fn = getattr(obs, "custom_call", None)
        if fn is not None:
            fn(name, operands, results)


class LaunchCounter(dict):
    """Launches of each hand-written kernel by name, counted from
    ``record_call`` (a call on ``meta``, the dry run's shape propagation,
    launches nothing). Counts while in ``observers``: as a context
    manager, or added and removed by the caller."""

    def __init__(self):
        super().__init__(flash_attention=0, ssd=0, ssd_bwd=0, gated_norm=0,
                         gated_norm_bwd=0, causal_conv=0, causal_conv_bwd=0)

    def custom_call(self, name, operands, results):
        if operands and operands[0].device.type != "meta":
            self[name] = self.get(name, 0) + 1

    def reset(self):
        for name in self:
            self[name] = 0

    def __enter__(self):
        observers.append(self)
        return self

    def __exit__(self, *exc):
        observers.remove(self)


def tracing() -> bool:
    """Whether spans and counters are recorded: some observer takes
    them."""
    return bool(observers) and any(
        hasattr(o, "span") or hasattr(o, "count") for o in observers)


class _Off:
    """The span while tracing is off: one shared object, nothing done."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ids = itertools.count()
_local = threading.local()      # .stack: this thread's open spans
_open: list = []                # every thread's open spans, in open order
_closed: List[SpanRecord] = []  # every closed span of a finished root


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _innermost():
    """This thread's innermost open span; in a thread with none (the
    autograd engine's), the process's innermost."""
    st = _stack()
    if st:
        return st[-1]
    return _open[-1] if _open else None


class _Span:
    """An open span. ``device``: time it on the card too, by a timing
    event at each end on the current stream, where the process uses CUDA
    (``torch.Event``, whose record finds the current stream in C++;
    ``torch.cuda.Event.record`` builds a Python stream object each
    time)."""
    __slots__ = ("name", "id", "parent", "root", "attrs", "counters",
                 "t0", "t1", "ev0", "ev1", "timed", "stack", "next",
                 "closed", "ref", "last")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.attrs = name, attrs
        self.timed = device and torch.cuda.is_initialized()
        self.counters = {}
        self.ev0 = self.ev1 = self.next = None

    def __enter__(self):
        self._open(_innermost(), _stack())
        return self

    def __exit__(self, *exc):
        s = self
        while s.next is not None:       # handed over (``handover``)
            s = s.next
        s._close()
        return False

    def _open(self, parent, stack):
        self.id = next(_ids)
        self.parent = parent
        self.root = self if parent is None else parent.root
        if parent is None:
            self.closed, self.ref, self.last = [], None, None
        self.stack = stack
        stack.append(self)
        _open.append(self)
        if self.timed:
            self.ev0 = self._event()
        self.t0 = time.time_ns()

    def _event(self):
        ev = torch.Event(torch.device("cuda", torch.cuda.current_device()),
                         enable_timing=True)
        ev.record()
        root = self.root
        if root.ref is None:
            root.ref = ev
        root.last = ev
        return ev

    def _close(self):
        self.t1 = time.time_ns()
        if self.timed:
            self.ev1 = self._event()
        if self in self.stack:
            self.stack.remove(self)
        if self in _open:
            _open.remove(self)
        self.root.closed.append(self)
        if self.parent is None:
            _finish(self)


def span(name: str, *, device: bool = True, **attrs):
    """A context manager that records one span while tracing is on: its
    name, attrs, parent (this thread's innermost open span, or in a thread
    with none the process's innermost) and root, its host times, and with
    ``device`` its device times. Off, the shared no-op: no allocation, no
    CUDA call, no clock read."""
    if not tracing():
        return _OFF
    return _Span(name, device, attrs)


def spanned(name: str, **kw):
    """Decorate a function so that each call runs inside ``span(name,
    **kw)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, **kw):
                return fn(*args, **kwargs)
        return inner
    return wrap


def handover(name: str, to: str):
    """End the innermost open span named ``name`` and open ``to`` in its
    place (the same parent and thread); the ``with`` block of ``name``
    then ends ``to``. A tensor hook marks a boundary inside one call this
    way (the fused backward's server and client parts). Nothing while
    tracing is off or no such span is open."""
    old = next((s for s in reversed(_open) if s.name == name), None)
    if old is None:
        return
    new = _Span(to, old.timed, {})
    stack, parent = old.stack, old.parent
    old._close()
    new._open(parent, stack)
    old.next = new


def count(name: str, n):
    """Add ``n`` (a number, or a 0-d tensor read when the root closes) to
    the counter ``name`` of the innermost open span; with none open, hand
    it to the observers now."""
    if not tracing():
        return
    sp = _innermost()
    if sp is None:
        _deliver([], {name: _value(n)})
        return
    sp.counters.setdefault(name, []).append(n)


def _value(n):
    return n.item() if isinstance(n, torch.Tensor) else n


def _finish(root: _Span):
    """A root closed: wait on its last event once, resolve device times
    (ms from the root's first event) and tensor counters, keep the spans
    and hand them to the observers."""
    done = sorted(root.closed, key=lambda s: s.id)
    if root.last is not None:
        root.last.synchronize()
    records, totals = [], {}
    for s in done:
        rec = SpanRecord(
            name=s.name, id=s.id, root=root.id,
            parent=None if s.parent is None else s.parent.id,
            host_start_ns=s.t0, host_end_ns=s.t1,
            attrs=s.attrs or None, counters=None)
        if s.ev0 is not None:
            rec.device_start_ms = _elapsed(root.ref, s.ev0)
            rec.device_end_ms = _elapsed(root.ref, s.ev1)
        if s.counters:
            rec.counters = {k: sum(_value(v) for v in vals)
                            for k, vals in s.counters.items()}
            for k, v in rec.counters.items():
                totals[k] = totals.get(k, 0) + v
        records.append(rec)
    root.closed = []
    _closed.extend(records)
    _deliver(records, totals)


def _elapsed(ref, ev) -> float:
    """ms from ``ref`` to ``ev``; an event on another stream than the
    root's last may still be pending."""
    try:
        return ref.elapsed_time(ev)
    except RuntimeError:
        ev.synchronize()
        return ref.elapsed_time(ev)


def _deliver(records, totals: dict):
    for obs in list(observers):
        fn = getattr(obs, "span", None)
        if fn is not None:
            for rec in records:
                fn(rec.name, rec.seconds)
        fn = getattr(obs, "count", None)
        if fn is not None:
            for name, n in totals.items():
                fn(name, n)


def spans() -> List[SpanRecord]:
    """Every span closed with its root since the last ``reset``, in open
    order within each root (a copy)."""
    return list(_closed)


def reset():
    """Forget the closed spans."""
    _closed.clear()
