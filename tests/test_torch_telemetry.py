"""The port's tracer (``repro_torch.telemetry``: ``span``, ``count``,
``observers``) on the CPU: off it does nothing, on it builds the span tree
of a CPSL round and of a serve call without moving a bit of either, and its
host times are on the profiler's clock. One ``requires_cuda`` test puts a
span beside the card's own profiler event."""
import dataclasses
import math
import threading
import time

import pytest
import torch

from repro_torch import kernels, streams, telemetry, tree
from repro_torch.configs import registry
from repro_torch.configs.base import CPSLConfig
from repro_torch.core import cpsl as cpsl_mod
from repro_torch.core.cpsl import CPSL
from repro_torch.core.splitting import make_split_model
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import ServeEngine

PHASES_FUSED = ["cpsl.client_fwd", "cpsl.server_fwd", "cpsl.server_bwd",
                "cpsl.client_bwd", "cpsl.client_opt", "cpsl.server_opt"]
PHASES_PROTOCOL = ["cpsl.client_fwd", "cpsl.server_fwd", "cpsl.server_bwd",
                   "cpsl.server_opt", "cpsl.client_bwd", "cpsl.client_opt"]


class Record:
    """The observer interface of the benchmark's record: spans by name
    (seconds), counters by name."""

    def __init__(self):
        self.spans, self.counters = {}, {}

    def span(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


@pytest.fixture
def rec():
    """A record in ``observers`` for the test; the closed spans forgotten
    before and after."""
    telemetry.reset()
    r = Record()
    telemetry.observers.append(r)
    yield r
    telemetry.observers.remove(r)
    telemetry.reset()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _named(spans, name):
    return [s for s in spans if s.name == name]


# -- the mechanism ------------------------------------------------------------

def test_kernels_observers_is_the_tracers_list():
    assert kernels.observers is telemetry.observers
    assert kernels.record_call is telemetry.record_call


def test_off_is_a_no_op(monkeypatch):
    """No observer: ``span`` hands back one shared object and reads no
    clock, records no CUDA event and keeps nothing."""
    telemetry.reset()
    assert not telemetry.observers
    reads = []
    monkeypatch.setattr(telemetry.time, "time_ns",
                        lambda: reads.append(1) or 0)
    monkeypatch.setattr(torch, "Event", None)
    a = telemetry.span("x", device=True, k=1)
    b = telemetry.span("y")
    assert a is b
    with a, b:
        telemetry.count("c", torch.tensor(3))
    telemetry.handover("x", "z")
    assert not reads and not telemetry.spans()


def test_an_observer_of_calls_alone_leaves_tracing_off():
    class Calls:
        def custom_call(self, name, operands, results):
            pass
    with telemetry.LaunchCounter():
        obs = Calls()
        telemetry.observers.append(obs)
        try:
            assert not telemetry.tracing()
            assert telemetry.span("x") is telemetry.span("y")
        finally:
            telemetry.observers.remove(obs)


def test_launch_counter_counts_launches_not_meta_calls():
    t = torch.empty(2)
    with telemetry.LaunchCounter() as n:
        telemetry.record_call("ssd", (t,), (t,))
        telemetry.record_call("ssd", (t.to("meta"),), (t,))
        telemetry.record_call("flash_attention", (t,), (t,))
    telemetry.record_call("ssd", (t,), (t,))     # no longer counting
    assert dict(n) == {"flash_attention": 1, "ssd": 1}
    n.reset()
    assert dict(n) == {"flash_attention": 0, "ssd": 0}


def test_nesting_parents_and_roots_across_threads(rec):
    """A thread with no open span takes the process's innermost open span
    as its parent, as the autograd engine's thread does."""
    with telemetry.span("root", device=False, a=1) as root:
        with telemetry.span("child", device=False):
            pass
        with telemetry.span("mid", device=False) as mid:
            def work():
                with telemetry.span("other", device=False):
                    with telemetry.span("leaf", device=False):
                        pass
            th = threading.Thread(target=work)
            th.start()
            th.join()
        with telemetry.span("second", device=False):
            pass
    with telemetry.span("root2", device=False):
        pass
    spans = telemetry.spans()
    assert [s.name for s in spans] == ["root", "child", "mid", "other",
                                       "leaf", "second", "root2"]
    by = {s.name: s for s in spans}
    assert by["root"].parent is None and by["root"].attrs == {"a": 1}
    assert by["child"].parent == by["mid"].parent == by["root"].id
    assert by["other"].parent == mid.id and by["leaf"].parent == \
        by["other"].id
    assert {s.root for s in spans[:6]} == {root.id}
    assert by["root2"].root == by["root2"].id != root.id
    for s in spans:
        assert s.host_start_ns <= s.host_end_ns
        assert s.device_start_ms is None
    assert by["root"].host_start_ns <= by["leaf"].host_start_ns <= \
        by["leaf"].host_end_ns <= by["root"].host_end_ns
    assert rec.spans.keys() == by.keys()
    assert all(len(v) == 1 and v[0] >= 0 for v in rec.spans.values())


def test_handover_ends_one_span_and_opens_its_sibling(rec):
    with telemetry.span("root", device=False):
        with telemetry.span("a", device=False):
            telemetry.handover("a", "b")
            with telemetry.span("in_b", device=False):
                pass
    by = {s.name: s for s in telemetry.spans()}
    assert by["a"].parent == by["b"].parent == by["root"].id
    assert by["in_b"].parent == by["b"].id
    assert by["a"].host_end_ns <= by["b"].host_start_ns


def test_counters_resolve_at_root_close_and_reach_the_record(rec):
    """Counters attach to the innermost open span; a 0-d tensor is read
    when its root closes; the observer gets each name's total."""
    with telemetry.span("root", device=False):
        telemetry.count("n", 2)
        with telemetry.span("inner", device=False):
            telemetry.count("n", torch.tensor(5))
            telemetry.count("n", 1)
            telemetry.count("m", torch.tensor(0.5))
    by = {s.name: s for s in telemetry.spans()}
    assert by["root"].counters == {"n": 2}
    assert by["inner"].counters == {"n": 6, "m": 0.5}
    assert isinstance(by["inner"].counters["n"], int)
    assert rec.counters == {"n": 8, "m": 0.5}
    telemetry.count("loose", 4)                  # no span open
    assert rec.counters["loose"] == 4


def test_span_records_round_trip_through_the_trace(rec, tmp_path):
    with telemetry.span("root", device=False, pos=3):
        with telemetry.span("leaf", device=False):
            telemetry.count("k", 7)
    w = telemetry.TraceWriter(str(tmp_path / "spans.jsonl"))
    for s in telemetry.spans():
        w.emit(s)
    lines = telemetry.load_trace(w.path)
    assert [d["kind"] for d in lines] == ["span", "span"]
    for d, s in zip(lines, telemetry.spans()):
        typed = telemetry.parse_record(d)
        assert isinstance(typed, telemetry.SpanRecord)
        assert typed == s and typed.to_dict() == d
    assert lines[0]["attrs"] == {"pos": 3} and lines[1]["counters"] == \
        {"k": 7}


def test_host_times_are_on_the_profilers_clock(rec):
    """A span's host times against a ``record_function`` range around the
    same work, read back from ``torch.profiler``: within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("probe", device=False), \
                record_function("probe_range"):
            for _ in range(20):
                a = torch.tanh(a @ a)
            time.sleep(0.01)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "probe_range"]
    assert len(ev) == 1
    sp = _named(telemetry.spans(), "probe")[0]
    assert abs(ev[0].start_ns() - sp.host_start_ns) < 1_000_000
    assert abs(ev[0].end_ns() - sp.host_end_ns) < 1_000_000


# -- the program's spans -----------------------------------------------------

def _cpsl(fused: bool):
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype="float32", ssd_impl="pallas")
    cp = CPSL(make_split_model(cfg, 1), CPSLConfig(
        cut_layer=1, n_clusters=2, cluster_size=2, local_epochs=1,
        batch_per_device=2, optimizer="sgd", fused_step=fused))
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 17),
                         generator=torch.Generator().manual_seed(0))

    def batch_fn(m, l):  # noqa: E741
        return {"tokens": toks[m, ..., :-1], "labels": toks[m, ..., 1:]}
    return cp, batch_fn


@pytest.mark.parametrize("fused", [True, False])
def test_cpsl_round_spans_leave_the_state_bit_equal(fused, monkeypatch):
    cp, batch_fn = _cpsl(fused)
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    telemetry.reset()
    off, m_off = cp.run_round(
        cp.init_state(streams.model_generator(0, "cpu")), batch_fn)
    assert not telemetry.spans()
    n_off = len(hooks)
    r = Record()
    telemetry.observers.append(r)
    try:
        on, m_on = cp.run_round(
            cp.init_state(streams.model_generator(0, "cpu")), batch_fn)
    finally:
        telemetry.observers.remove(r)
    assert cpsl_mod._client_bwd not in hooks[:n_off]
    assert (cpsl_mod._client_bwd in hooks[n_off:]) == fused
    assert m_on == m_off
    for a, b in zip(tree.leaves(on), tree.leaves(off)):
        assert torch.equal(a, b)

    spans = telemetry.spans()
    telemetry.reset()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["cpsl.round"]
    top = _children(spans, roots[0])
    assert [s.name for s in top] == ["cpsl.step", "cpsl.fedavg"] * 2
    assert [s.attrs for s in top[::2]] == [{"cluster": 0, "epoch": 0},
                                           {"cluster": 1, "epoch": 0}]
    phases = PHASES_FUSED if fused else PHASES_PROTOCOL
    for step in top[::2]:
        assert [s.name for s in _children(spans, step)] == phases
    # K2's Function backward under both halves of the backward: the
    # device side holds layer 0, the server the others
    by_id = {s.id: s for s in spans}
    parents = [by_id[s.parent].name for s in _named(spans, "ssd.bwd")]
    assert set(parents) == {"cpsl.server_bwd", "cpsl.client_bwd"}
    assert r.spans.keys() == {s.name for s in spans}
    assert len(r.spans["cpsl.step"]) == 2


def _moe_cfg():
    return registry.reduce_for_smoke(
        registry.get("deepseek-v2-lite-16b")).replace(dtype="float32")


def test_generate_spans_leave_the_tokens_equal(rec):
    cfg = _moe_cfg()
    params = tfm.init(streams.model_generator(0, "cpu"), cfg)
    eng = ServeEngine(cfg, params, cap=40, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    steps = 5
    telemetry.observers.remove(rec)
    off = eng.generate({"tokens": toks}, steps=steps)
    assert not telemetry.spans()
    telemetry.observers.append(rec)
    on = eng.generate({"tokens": toks}, steps=steps)
    assert torch.equal(on, off)

    spans = telemetry.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["serve.generate"]
    top = _children(spans, roots[0])
    assert [s.name for s in top] == (["serve.prefill", "serve.sample"]
                                     + ["serve.decode", "serve.sample"]
                                     * (steps - 1))
    assert [s.attrs for s in top if s.name == "serve.decode"] == [
        {"pos": 16 + i} for i in range(steps - 1)]
    n_moe = sum(spec.ffn == "moe" for spec in cfg.layer_specs())
    for s in top:
        inner = _children(spans, s)
        if s.name == "serve.sample":
            assert not inner
        else:
            assert [c.name for c in inner] == ["moe"] * n_moe
    # no_drop at these sizes: every choice kept
    B, S, k = 2, 16, cfg.moe.top_k
    want = n_moe * k * (B * S + B * (steps - 1))
    assert rec.counters == {"moe.choices": want, "moe.kept": want}
    assert len(rec.spans["serve.sample"]) == steps


def _kept_directly(p, x, cfg):
    """The choices given a slot, counted apart from the dispatch: in each
    group, each expert keeps the first C of the choices routed to it."""
    m = cfg.moe
    B, S, D = x.shape
    g = cm._largest_divisor(B * S, m.group_size)
    _, _, idx = cm.moe_route(p, x.reshape(-1, g, D), m.top_k)
    C = int(math.ceil(g * m.top_k / m.n_experts * m.capacity_factor))
    per = torch.stack([(idx == e).sum(dim=(1, 2))
                       for e in range(m.n_experts)])
    return int(torch.clamp(per, max=C).sum())


def test_moe_counters_count_the_dropped_choices(rec):
    cfg = _moe_cfg()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    p = cm.moe_init(streams.model_generator(2, "cpu"), cfg)
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    with telemetry.span("root", device=False):
        cm.moe_apply(p, x, cfg)
        cm.moe_apply(p, x, cfg, no_drop=True)
    drop, full = _named(telemetry.spans(), "moe")
    choices = 2 * 32 * cfg.moe.top_k
    assert drop.counters["moe.choices"] == full.counters["moe.choices"] \
        == choices
    assert drop.counters["moe.kept"] == _kept_directly(p, x, cfg) < choices
    assert full.counters["moe.kept"] == choices


# -- on the card -------------------------------------------------------------

@pytest.mark.requires_cuda
def test_span_holds_its_kernels_profiler_event(rec):
    """A span around a synchronised ``torch.cuda._sleep``, with 2 ms of
    host time on either side of the kernel: the kernel's event from
    ``torch.profiler`` lies inside the span's host interval, and the span's
    device time covers the kernel's; twice (the first launch pays for
    loading the kernel). Printed: the kernel's profiler start less
    the host clock read just before its launch (launch latency plus the
    two clocks' offset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for attempt in range(2):
        telemetry.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with telemetry.span("sleep"):
                time.sleep(0.002)
                launch = time.time_ns()
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
                time.sleep(0.002)
        kern = [e for e in prof.profiler.kineto_results.events()
                if "CUDA" in str(e.device_type())
                and not e.name().startswith(("Memcpy", "Memset"))]
        assert len(kern) == 1, [e.name() for e in kern]
        sp = _named(telemetry.spans(), "sleep")[0]
        print(f"kernel's profiler start - host clock at launch: "
              f"{(kern[0].start_ns() - launch) / 1e3:.1f} us")
        assert sp.host_start_ns < kern[0].start_ns()
        assert kern[0].end_ns() < sp.host_end_ns
        assert sp.device_start_ms == 0.0
        assert sp.device_ms >= kern[0].duration_ns() / 1e6 * 0.99
