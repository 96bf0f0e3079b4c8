"""The readers of the program's spans and counters (``harness/spans.py``
and the ten ``metrics/*`` files that use it) on a synthetic record: spans
and counters built as the program's tracer builds them, and trace sessions
whose events sit at known times on the same clock."""
import numpy as np
import pytest

from perfbench.harness import bench, spans as hs

TRAIN_METRICS = ["client_ms.train", "server_ms.train", "fedavg_ms.train",
                 "ssd_bwd_pct.train", "idle_in_round_pct.train"]
SERVE_METRICS = ["moe_pct.prefill", "moe_drop_pct.prefill", "moe_pct.decode",
                 "token_gap_ms_p95.decode", "idle_in_step_pct.decode"]
MS = 1_000_000          # ns


class Session:
    """A trace session: its phase, wall and events (name, start us,
    duration us, kind)."""

    def __init__(self, phase, wall_s, events):
        self.phase, self.wall_s, self.events = phase, wall_s, events

    def kernels(self):
        return [e for e in self.events if e[3] == "kernel"]


class Spans:
    """SpanRecords as the tracer makes them: ids in open order, host times
    in ns, device times in ms from the root's first event."""

    def __init__(self):
        from repro_torch.telemetry import SpanRecord
        self.make, self.out, self.next = SpanRecord, [], 0

    def add(self, name, t0_ms, t1_ms, parent=None, dev=None, **counters):
        rec = self.make(name=name, id=self.next,
                        root=self.next if parent is None else parent.root,
                        parent=None if parent is None else parent.id,
                        host_start_ns=int(t0_ms * MS),
                        host_end_ns=int(t1_ms * MS),
                        device_start_ms=None if dev is None else dev[0],
                        device_end_ms=None if dev is None else dev[1],
                        counters=counters or None)
        self.next += 1
        self.out.append(rec)
        return rec


@pytest.fixture
def program(monkeypatch):
    sp = Spans()
    from repro_torch import telemetry
    monkeypatch.setattr(telemetry, "spans", lambda: list(sp.out))
    return sp


def _record(spans=None):
    rec = bench.Record({}, {})
    for s in spans or []:
        rec.span(s.name, s.seconds)
    return rec


def _read(name, rec):
    return bench.load_module("metrics", name).read(rec)


def test_no_tracer_no_reading(monkeypatch):
    """A program without the tracer: every reader of its spans returns
    None and raises nothing."""
    from repro_torch import telemetry
    monkeypatch.delattr(telemetry, "spans")
    rec = bench.Record({}, {})
    rec.sessions = [Session("round", 1.0, [("k", 0.0, 10.0, "kernel")]),
                    Session("decode", 1.0, [("k", 0.0, 10.0, "kernel")])]
    for name in TRAIN_METRICS + SERVE_METRICS:
        assert _read(name, rec) is None, name


def test_train_readers(program):
    sp = program
    t = 1_000_000.0                     # ms on the epoch clock
    rnd = sp.add("cpsl.round", t, t + 100, dev=(0.0, 100.0))
    step = sp.add("cpsl.step", t + 1, t + 80, rnd, dev=(1.0, 80.0))
    phases = (("cpsl.client_fwd", 1, 11), ("cpsl.server_fwd", 11, 31),
              ("cpsl.server_bwd", 31, 61), ("cpsl.client_bwd", 61, 76),
              ("cpsl.client_opt", 76, 78), ("cpsl.server_opt", 78, 80))
    for name, a, b in phases:
        s = sp.add(name, t + a, t + b, step, dev=(a, b))
        if name in ("cpsl.server_bwd", "cpsl.client_bwd"):
            sp.add("ssd.bwd", t + a, t + a + 5, s, dev=(a, a + 5))
    sp.add("cpsl.fedavg", t + 82, t + 95, rnd, dev=(82.0, 95.0))
    # the plan, before the round: host only
    sp.add("resource.gibbs", t - 30, t - 1)
    rec = _record(sp.out)
    # busy 0-50 and 60-100 ms of the round's clock; the session holds
    # the plan's 30 ms of idle before the round
    us = t * 1e3
    rec.sessions = [Session("round", 0.131, [
        ("a", us, 50e3, "kernel"), ("b", us + 20e3, 10e3, "kernel"),
        ("c", us + 60e3, 40e3, "kernel")])]
    got = {n: _read(n, rec) for n in TRAIN_METRICS}
    assert got["client_ms.train"] == pytest.approx(10 + 15 + 2)
    assert got["server_ms.train"] == pytest.approx(20 + 30 + 2)
    assert got["fedavg_ms.train"] == pytest.approx(13)
    assert got["ssd_bwd_pct.train"] == pytest.approx(10.0)
    # idle inside the round: 50-60 ms only
    assert got["idle_in_round_pct.train"] == pytest.approx(
        100 * 0.010 / 0.131)


def _serve_spans(sp, t, drop):
    gen = sp.add("serve.generate", t, t + 400, dev=(0.0, 400.0))
    pre = sp.add("serve.prefill", t, t + 100, gen, dev=(0.0, 100.0))
    for i in range(2):
        sp.add("moe", t + 10 + 40 * i, t + 30 + 40 * i, pre,
               dev=(10.0 + 40 * i, 30.0 + 40 * i), **{
                   "moe.choices": 600, "moe.kept": 600 - drop})
    end = 100.0
    gaps = [0.0, 30.0, 40.0, 20.0, 50.0, 30.0]
    for j, g in enumerate(gaps):
        if j:
            dec = sp.add("serve.decode", t + end, t + end + g - 2, gen,
                         dev=(end, end + g - 2))
            sp.add("moe", t + end + 1, t + end + 1 + g / 2, dec,
                   dev=(end + 1, end + 1 + g / 2),
                   **{"moe.choices": 6, "moe.kept": 6})
        end += g
        sp.add("serve.sample", t + end - 2, t + end, gen, dev=(end - 2, end))
    return gaps[1:]


def test_serve_readers(program):
    sp = program
    t = 2_000_000.0
    gaps = _serve_spans(sp, t, drop=30) + _serve_spans(sp, t + 1000, drop=0)
    rec = _record(sp.out)
    us = t * 1e3
    # decode sessions: the card idle 100-110 ms and 150-160 ms of the
    # first call, busy the rest; the second call's session all busy
    rec.sessions = [
        Session("decode", 0.2, [("k", us + 90e3, 10e3, "kernel"),
                                ("k", us + 110e3, 40e3, "kernel"),
                                ("k", us + 160e3, 200e3, "kernel")]),
        Session("decode", 0.1, [("k", us + 1e6 + 90e3, 400e3, "kernel")])]
    got = {n: _read(n, rec) for n in SERVE_METRICS}
    assert got["moe_pct.prefill"] == pytest.approx(40.0)
    assert got["moe_drop_pct.prefill"] == pytest.approx(
        100 * 60 / 2400)
    dec = [s for s in sp.out if s.name == "serve.decode"]
    moe_dec = [s for s in sp.out if s.name == "moe" and s.parent in
               {d.id for d in dec}]
    assert got["moe_pct.decode"] == pytest.approx(
        100 * sum(s.device_ms for s in moe_dec)
        / sum(s.device_ms for s in dec))
    assert got["token_gap_ms_p95.decode"] == pytest.approx(
        float(np.percentile(gaps, 95)))
    # decode spans of call 1: 100-128, 130-168, ...: idle 100-110 inside
    # the first, 150-160 inside the second
    assert got["idle_in_step_pct.decode"] == pytest.approx(
        100 * 0.020 / 0.3)


def test_idle_within_counts_gaps_under_the_intervals_only():
    ev = [("a", 0.0, 10.0, "kernel"), ("b", 5.0, 10.0, "kernel"),
          ("c", 30.0, 10.0, "kernel"), ("d", 50.0, 5.0, "kernel")]
    sess = [Session("x", 1.0, ev)]
    ns = 1000       # us -> ns
    # idle: 15-30, 40-50, and after 55
    assert hs.idle_within(sess, [(0, 100 * ns)]) == pytest.approx(70e-6)
    assert hs.idle_within(sess, [(20 * ns, 45 * ns)]) == pytest.approx(
        15e-6)
    assert hs.idle_within(sess, [(0, 12 * ns), (32 * ns, 38 * ns)]) == 0.0
    assert hs.idle_within(sess, [(16 * ns, 17 * ns), (41 * ns, 60 * ns)]) \
        == pytest.approx(1e-6 + 14e-6)
    assert hs.idle_within(sess, []) == 0.0
