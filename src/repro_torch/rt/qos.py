"""QoS telemetry for the deployment runtime (the port of
``repro.rt.qos``).

The runtime emits the SAME JSONL schema as the simulator
(``repro_torch.telemetry``): per-round ``RoundRecord``s (with measured
``wall_s`` plus the plan/network snapshot keys the repricer needs) and
per-device ``QoSRecord`` phase timings. One trace file can therefore be
read by ``sim.engine.recompute_trace_latencies`` (which skips the QoS
lines) and by ``rt.crossval`` (which joins measured and predicted per
round).

Device workers run in other processes, so they don't write the trace
file directly: each worker accumulates its ``QoSRecord`` dicts locally
and ships them piggybacked on the end-of-cluster AGG upload; the server
folds them into the single trace. (QoS of a device that fails to upload
is lost with it — telemetry is best-effort, numerics are not.)
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Optional

from repro_torch.telemetry import QoSRecord, TraceWriter


class QoSMonitor:
    """Accumulates QoSRecords; optionally mirrors them to a TraceWriter
    (server-side) or just buffers for piggybacking (device-side)."""

    def __init__(self, writer: Optional[TraceWriter] = None,
                 device: int = -1):
        self.writer = writer
        self.device = device
        self.records: List[dict] = []

    def emit(self, rnd: int, phase: str, t_s: float, device: int = None,
             **kw) -> dict:
        rec = QoSRecord(round=int(rnd),
                        device=self.device if device is None else int(device),
                        phase=phase, t_s=float(t_s), **kw).to_dict()
        self.records.append(rec)
        if self.writer is not None:
            self.writer.emit(rec)
        return rec

    @contextmanager
    def phase(self, rnd: int, phase: str, device: int = None, **kw):
        """Time a block and emit it as one QoSRecord."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.emit(rnd, phase, time.monotonic() - t0, device=device,
                      **kw)

    def drain(self) -> List[dict]:
        """Hand over (and clear) the buffered records — the device
        worker calls this when building its AGG payload."""
        out, self.records = self.records, []
        return out


def round_wall_clocks(records) -> dict:
    """{round: measured wall seconds} from a trace's rt RoundRecords."""
    out = {}
    for rec in records:
        if rec.get("kind") != "qos" and "wall_s" in rec \
                and not rec.get("skipped"):
            out[int(rec["round"])] = float(rec["wall_s"])
    return out
