"""The rt runtime's control plane in the port against the reference, with
no processes: the retry/backoff arithmetic (``lifecycle``), the config
check (``RTConfig.validate``), the fault rules and seeded chaos schedules
(``rt.faults``), the orchestrator's per-round plans in "fixed" and
"controller" mode, and the crossval report. Every decision must equal
the reference's: these are NumPy and Python in both packages.

The reference's orchestrator and crossval import ``repro.sim``, which
imports on jax 0.9 only under ``tests/_cpsl_ref.py``'s patches; the
``ref`` fixture applies them for this module and takes them back.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _cpsl_ref
from _hyp import given, settings, st
from repro import lifecycle as rlife
from repro.rt import faults as rfaults
from repro_torch import lifecycle as tlife
from repro_torch import streams as tstreams
from repro_torch.rt import faults as tfaults
from repro_torch.rt import orchestrator as torch_orch
from repro_torch.rt.crossval import crossval_report
from repro_torch.rt.protocol import MsgType

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        modules.orch = importlib.import_module("repro.rt.orchestrator")
        modules.crossval = importlib.import_module("repro.rt.crossval")
        modules.engine = importlib.import_module("repro.sim.engine")
        yield modules


# -- lifecycle: retry/backoff arithmetic ------------------------------------

@settings(max_examples=150, deadline=None)
@given(retries=st.integers(0, 8), backoff0=st.floats(1e-3, 10.0),
       cap=st.floats(1e-3, 20.0), timeout=st.floats(0.1, 30.0))
def test_retry_arithmetic_matches_reference(retries, backoff0, cap, timeout):
    sleeps = tlife.retry_sleeps(retries, backoff0, cap)
    assert sleeps == rlife.retry_sleeps(retries, backoff0, cap)
    assert len(sleeps) == retries
    assert all(s <= cap for s in sleeps)
    assert all(b >= a for a, b in zip(sleeps, sleeps[1:]))
    assert tlife.retry_budget_s(timeout, retries, backoff0, cap) == \
        rlife.retry_budget_s(timeout, retries, backoff0, cap)


@settings(max_examples=50, deadline=None)
@given(initial=st.floats(1e-3, 5.0), cap=st.floats(1e-3, 10.0),
       resets=st.lists(st.integers(0, 6), max_size=4))
def test_backoff_matches_reference(initial, cap, resets):
    a, b = tlife.Backoff(initial, cap), rlife.Backoff(initial, cap)
    for n in resets:
        assert [a.next() for _ in range(n)] == [b.next() for _ in range(n)]
        a.reset()
        b.reset()
    assert a.next() == b.next() == initial


def test_retry_known_values():
    assert tlife.retry_sleeps(4, 0.25, cap=1.0) == [0.25, 0.5, 1.0, 1.0]
    assert tlife.retry_sleeps(0, 0.25, cap=1.0) == []
    assert tlife.retry_budget_s(2.0, 4, 0.25, 1.0) == pytest.approx(12.75)
    b = tlife.Backoff(0.25, cap=1.0)
    assert [b.next() for _ in range(4)] == [0.25, 0.5, 1.0, 1.0]


# -- RTConfig --------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(timeout=st.floats(0.1, 30.0), retries=st.integers(0, 6),
       backoff0=st.floats(1e-3, 2.0), cap=st.floats(0.1, 5.0),
       slack=st.floats(-5.0, 100.0))
def test_validate_matches_reference(ref, timeout, retries, backoff0, cap,
                                    slack):
    """RTConfig.validate() accepts a config iff the reference's does: the
    device retry budget must stay under the phase deadline."""
    budget = tlife.retry_budget_s(timeout, retries, backoff0, cap)
    kw = dict(rpc_timeout_s=timeout, retries=retries, backoff_s=backoff0,
              backoff_max_s=cap, phase_timeout_s=max(budget + slack, 0.01))
    results = []
    for cls in (torch_orch.RTConfig, ref.orch.RTConfig):
        cfg = cls(**kw)
        try:
            assert cfg.validate() is cfg
            results.append("ok")
        except ValueError as e:
            assert "retry budget" in str(e)
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] == "ok") == (kw["phase_timeout_s"] > budget)


@pytest.mark.parametrize("arrivals", [{5: 1}, {1: 4}, {1: -1}])
def test_validate_refuses_bad_arrivals(ref, arrivals):
    kw = dict(n_devices=4, rounds=3, arrivals=arrivals)
    with pytest.raises(ValueError, match="arrivals") as ours:
        torch_orch.RTConfig(**kw).validate()
    with pytest.raises(ValueError) as theirs:
        ref.orch.RTConfig(**kw).validate()
    assert str(ours.value) == str(theirs.value)


def test_config_fields_are_the_references_plus_device(ref):
    ours = {f for f in torch_orch.RTConfig.__dataclass_fields__}
    theirs = {f for f in ref.orch.RTConfig.__dataclass_fields__}
    assert ours - theirs == {"device"} and not theirs - ours
    assert torch_orch.RTConfig().device == "cuda"
    tc = torch_orch.RTConfig(n_devices=6, cluster_size=3).ccfg()
    rc = ref.orch.RTConfig(n_devices=6, cluster_size=3).ccfg()
    for f in ("cut_layer", "n_clusters", "cluster_size", "local_epochs",
              "lr_device", "lr_server", "batch_per_device", "optimizer",
              "momentum", "weight_decay", "fused_step"):
        assert getattr(tc, f) == getattr(rc, f), f
    assert tc.unroll_clients      # workers run one client each


def test_no_cuda_raises_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_orch.RTConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_orch.Orchestrator(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_orch.loopback_reference(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_orch.run_elastic(torch_orch.RTConfig(
            wal_dir=str(tmp_path / "wal"),
            trace_path=str(tmp_path / "t.jsonl")))


# -- faults ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rounds=3, n_devices=2),
    dict(rounds=5, n_devices=30, kill_workers=3, kill_server=2,
         blackholes=2),
    dict(rounds=1, n_devices=4, kill_workers=2, kill_server=1),
    dict(rounds=8, n_devices=6, kill_workers=0, kill_server=4,
         blackholes=5),
])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_chaos_schedule_matches_reference(kw, seed):
    ours = tfaults.chaos_schedule(seed, **kw)
    theirs = rfaults.chaos_schedule(seed, **kw)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.events == theirs.events
    assert {g: [r.to_dict() for r in rs]
            for g, rs in ours.worker_faults.items()} == \
        {g: [r.to_dict() for r in rs]
         for g, rs in theirs.worker_faults.items()}
    assert tstreams.chaos_rng(seed).random() == \
        np.random.default_rng(seed).random()


def test_chaos_stream_registered_and_disjoint():
    """``chaos`` sits in the port's registry as the reference's scalar
    stream, and the tuple pool's disjointness proof still holds."""
    from repro import streams as rstreams
    ours, theirs = tstreams.REGISTRY["chaos"], rstreams.REGISTRY["chaos"]
    assert (ours.pool, tuple(ours.key)) == (theirs.pool, tuple(theirs.key))
    assert ours.pool == "scalar"
    assert tstreams.registry_overlaps() == []
    g = tstreams.warmup_generator("cpu")
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(0)))


def _rules(mod):
    R, M = mod.FaultRule, MsgType
    return [R("delay", delay_s=0.5, msg_types=(int(M.SMASHED),)),
            R("drop", msg_types=(int(M.AGG),), rounds=(1, 3), times=2),
            R("disconnect", after=3, msg_types=(int(M.SMASHED),)),
            R("slow", delay_s=0.25, rounds=(2,), times=1),
            R("slow", delay_s=0.125, after=1),
            R("kill", msg_types=(int(M.AGG),), rounds=(4,), times=1,
              incarnations=(0,))]


def test_fault_injector_decisions_match_reference():
    """A fixed stream of sends and compute phases: every decision (and
    the rule's firing window) equals the reference's."""
    rng = np.random.default_rng(0)
    ours = tfaults.FaultInjector(_rules(tfaults))
    theirs = rfaults.FaultInjector(_rules(rfaults))
    for _ in range(200):
        rnd = None if rng.random() < 0.1 else int(rng.integers(5))
        if rng.random() < 0.3:
            assert ours.compute_delay(rnd) == theirs.compute_delay(rnd)
        else:
            mt = MsgType(int(rng.integers(1, 15)))
            assert ours.on_send(mt, rnd) == theirs.on_send(mt, rnd)
    assert [r.hits for r in ours.rules] == [r.hits for r in theirs.rules]
    for r in _rules(tfaults):
        d = r.to_dict()
        assert d == rfaults.FaultRule.from_dict(d).to_dict()
        assert tfaults.FaultRule.from_dict(d) == r
        assert r.active_in(0) == rfaults.FaultRule.from_dict(d).active_in(0)


# -- plans, delays, crossval -------------------------------------------------

def _plans(orch, rounds, roster=None):
    return [orch.plan_round(r, roster) for r in range(rounds)]


def _assert_plan_equal(a, b):
    assert a.v == b.v and a.stale == b.stale
    assert [list(map(int, c)) for c in a.clusters] == \
        [list(map(int, c)) for c in b.clusters]
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
    assert len(a.xs) == len(b.xs)
    for x, y in zip(a.xs, b.xs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.latency == b.latency


@pytest.mark.parametrize("plan, roster", [
    ("fixed", None), ("fixed", [0, 2, 3, 5, 6, 7]),
    ("controller", None), ("controller", [1, 2, 4, 5, 7]),
])
def test_plan_round_matches_reference(ref, plan, roster):
    """The orchestrator's per-round plans, over the whole population and
    over a roster (a grown/shrunk membership), equal the reference's:
    the contiguous equal-split layout, or the two-timescale controller's
    Gibbs + greedy plan, latency included."""
    kw = dict(n_devices=8, cluster_size=3, n_subcarriers=9, plan=plan,
              gibbs_iters=10, seed=3)
    ours = torch_orch.Orchestrator(torch_orch.RTConfig(device="cpu", **kw))
    theirs = ref.orch.Orchestrator(ref.orch.RTConfig(**kw))
    for (p, net), (q, rnet) in zip(_plans(ours, 3, roster),
                                   _plans(theirs, 3, roster)):
        _assert_plan_equal(p, q)
        np.testing.assert_array_equal(net.f, rnet.f)
        np.testing.assert_array_equal(net.rate, rnet.rate)


def test_wireless_delay_rules_match_reference(ref):
    kw = dict(n_devices=6, cluster_size=3, delay_scale=0.05, seed=1,
              faults={2: [tfaults.FaultRule("drop", times=1)]})
    ours = torch_orch.Orchestrator(torch_orch.RTConfig(device="cpu", **kw))
    rkw = dict(kw, faults={2: [rfaults.FaultRule("drop", times=1)]})
    theirs = ref.orch.Orchestrator(ref.orch.RTConfig(**rkw))
    assert ours._worker_faults() == theirs._worker_faults()
    (p, net), (q, rnet) = ours.plan_round(0), theirs.plan_round(0)
    a = tfaults.wireless_delay_rules(p, net, ours.ncfg, ours.prof, 16, 1.0)
    b = rfaults.wireless_delay_rules(q, rnet, theirs.ncfg, theirs.prof, 16,
                                     1.0)
    assert {g: [r.to_dict() for r in rs] for g, rs in a.items()} == \
        {g: [r.to_dict() for r in rs] for g, rs in b.items()}


def _trace(orch, rounds):
    """A loopback-shaped trace: round records with the plan snapshot and
    a measured wall, interleaved with QoS lines."""
    from repro_torch.telemetry import jsonable
    out = []
    for rnd in range(rounds):
        plan, net = orch.plan_round(rnd)
        out.append({"kind": "qos", "round": rnd, "device": 0,
                    "phase": "fwd", "t_s": 0.01})
        out.append(jsonable({
            "round": rnd, "v": plan.v, "stale": False, "ids": plan.ids,
            "clusters": plan.clusters, "xs": plan.xs,
            "planned_latency_s": plan.latency, "latency_s": plan.latency,
            "f": net.f, "rate": net.rate, "wall_s": 0.05 * (rnd + 1),
            "dropped": [], "source": "rt"}))
    out.append({"round": rounds, "skipped": True})
    return out


def test_crossval_report_matches_reference(ref, tmp_path):
    orch = torch_orch.Orchestrator(torch_orch.RTConfig(
        n_devices=6, cluster_size=3, device="cpu"))
    records = _trace(orch, 3)
    ours = crossval_report(records, orch.prof, orch.ncfg, 8, 1,
                           path=str(tmp_path / "cv.json"))
    rprof = ref.profile.lenet_profile()
    rncfg = ref.channel.NetworkCfg(n_devices=6, n_subcarriers=6)
    theirs = ref.crossval.crossval_report(records, rprof, rncfg, 8, 1)
    assert ours == theirs
    assert ours["summary"]["n_rounds"] == 3
    assert crossval_report(records) == ref.crossval.crossval_report(records)


# -- imports ------------------------------------------------------------------

def test_spawn_target_imports_neither_jax_nor_reference():
    """A worker process imports ``repro_torch.rt.device`` (and the
    orchestrator's supervisor ``repro_torch.rt.orchestrator``): neither
    pulls in JAX or the reference."""
    code = ("import sys; import repro_torch.rt.device, "
            "repro_torch.rt.orchestrator, repro_torch.rt.crossval; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
