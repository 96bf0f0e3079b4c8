"""The port's wireless-dynamics layer against the reference, on the CPU:
``sim.dynamics.NetworkProcess``, the two-timescale controller, the JSONL
telemetry, the simulator's random streams and ``sim.engine.SimEngine``.

Everything below the trainer is NumPy on both sides, so it is held bit
for bit: trajectories, events and batteries, cut / cluster / allocation
decisions and their latencies, trace lines. ``SimEngine`` makes the
reference's decisions with ``train=False``; with ``train=True`` at a fixed
cut, started from the reference's first state
(``convert.cpsl_state_from_numpy``), its losses and parameters stay
within ``ATOL_PAPER`` per leaf of the reference's over 3 rounds.

The reference is imported inside a module-scoped fixture, under
``tests/_cpsl_ref.py::reference()``.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import streams
from repro_torch import telemetry as ttel
from repro_torch.configs.base import CPSLConfig, SimCfg
from repro_torch.convert import cpsl_state_from_numpy
from repro_torch.core.channel import NetworkCfg, NetworkState
from repro_torch.core.profile import lenet_profile
from repro_torch.data.pipeline import CPSLDataset
from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
from repro_torch.sim import controller as tctl
from repro_torch.sim.dynamics import DynamicsCfg, Event, NetworkProcess
from repro_torch.sim.engine import (SimEngine, device_round_energy,
                                    recompute_trace_latencies)
from test_torch_cpsl import ATOL_PAPER, assert_state_close

PROF = lenet_profile()


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as m:
        for name in ("dynamics", "controller", "engine", "fleet"):
            setattr(m, "sim_" + name,
                    importlib.import_module("repro.sim." + name))
        m.telemetry = importlib.import_module("repro.telemetry")
        yield m


def _cfgs(ref, n=12, **dkw):
    ncfg = dict(n_devices=n, n_subcarriers=2 * n)
    return ((ref.channel.NetworkCfg(**ncfg), ref.sim_dynamics.DynamicsCfg(
        **dkw)), (NetworkCfg(**ncfg), DynamicsCfg(**dkw)))


def _same_events(a, b):
    assert [e.to_dict() for e in a] == [e.to_dict() for e in b]


# --------------------------------------------------------------------------
# streams
# --------------------------------------------------------------------------

def test_sim_streams_match_reference(ref):
    """Every simulator stream the reference defines draws the same
    numbers in the port."""
    rs = ref.streams
    for name, args in (("dynamics_rng", (4,)),
                       ("fleet_reserve_means_rng", (3,)),
                       ("fleet_departures_rng", (1, 7)),
                       ("fleet_arrivals_rng", (1, 7)),
                       ("fleet_gibbs_rng", (2, 5)),
                       ("fleet_saa_rng", (2, 5))):
        np.testing.assert_array_equal(
            getattr(streams, name)(*args).random(16),
            getattr(rs, name)(*args).random(16), err_msg=name)
    for seed, c in ((5, 0), (5, 3)):
        assert streams.chain_key(seed, c) == rs.chain_key(seed, c)
    assert streams.FLEET_DEPART_TAG == rs.FLEET_DEPART_TAG
    assert streams.FLEET_SAA_TAG == rs.FLEET_SAA_TAG
    assert streams.REGISTRY["dynamics"].pool == "scalar"


def test_fleet_innovations_stream_is_disjoint():
    """The port's innovation stream is registered, collides with no other
    pattern, and refuses episode seeds past its bound (the bound is what
    keeps it apart from ``bucket_chain`` and ``lm_batch``)."""
    assert streams.registry_overlaps() == []
    spec = streams.REGISTRY["fleet_innovations"]
    assert spec.pool == "tuple" and spec.key[2] == streams.FLEET_INNOV_TAG
    unbounded = dict(streams.REGISTRY)
    unbounded["fleet_innovations"] = dataclasses.replace(
        spec, key=(streams.Sym("seed"), streams.Sym("episode"),
                   streams.FLEET_INNOV_TAG))
    assert len(streams.registry_overlaps(unbounded)) == 2
    with pytest.raises(ValueError, match="episode seed"):
        streams.fleet_innovations_rng(0, streams.EPISODE_MAX)
    a = streams.fleet_innovations_rng(0, 3).standard_normal(8)
    np.testing.assert_array_equal(
        a, np.random.default_rng((0, 3, streams.FLEET_INNOV_TAG))
        .standard_normal(8))


# --------------------------------------------------------------------------
# NetworkProcess
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hooks", [False, True], ids=["own-rng", "u-hooks"])
def test_network_process_matches_reference(ref, hooks):
    """A 20-slot trajectory with forced and Bernoulli churn, arrivals,
    the floor and energy drain: f, snr, active ids, events and batteries
    bit-equal every slot; with ``hooks`` the decisions come from shared
    uniforms (``u=``) and the events carry an explicit ``slot=``."""
    (rn, rd), (tn, td) = _cfgs(
        ref, rho_snr=0.8, rho_f=0.9, p_depart=0.1, p_arrive=0.4,
        min_devices=5, energy_budget_j=3.0, seed=3,
        forced_departures={2: (1, 4), 6: (0,), 9: (40,)})
    rp, tp = ref.sim_dynamics.NetworkProcess(rn, rd), NetworkProcess(tn, td)
    u = np.random.default_rng(11)
    kinds = set()
    for t in range(20):
        rnet, rids = rp.snapshot()
        tnet, tids = tp.snapshot()
        np.testing.assert_array_equal(tids, rids)
        np.testing.assert_array_equal(tnet.f, rnet.f)
        np.testing.assert_array_equal(tnet.rate, rnet.rate)
        np.testing.assert_array_equal(tp.snr_db, rp.snr_db)
        np.testing.assert_array_equal(tp.means_of(tids)[0],
                                      rp.means_of(rids)[0])
        if hooks:
            ud = u.random(tp.n_devices)
            ev = (rp.sample_departures(slot=t, u=ud),
                  tp.sample_departures(slot=t, u=ud))
        else:
            ev = (rp.sample_departures(), tp.sample_departures())
        _same_events(*ev)
        ids = tp.active_ids()
        joules = np.linspace(0.4, 1.6, len(ids))
        ev2 = (rp.consume(ids, joules), tp.consume(ids, joules))
        _same_events(*ev2)
        ua = float(u.random()) if hooks else None
        ev3 = (rp.sample_arrivals(u=ua), tp.sample_arrivals(u=ua))
        _same_events(*ev3)
        kinds |= {(e.kind, e.cause) for e in ev[1] + ev2[1] + ev3[1]}
        np.testing.assert_array_equal(tp.energy, rp.energy)
        np.testing.assert_array_equal(tp.active, rp.active)
        rp.evolve()
        tp.evolve()
        assert tp.slot == rp.slot
    assert tp.n_active >= td.min_devices
    assert {("depart", None), ("arrive", None),
            ("energy_depleted", None)} <= kinds


def test_event_dict_keeps_cause():
    assert Event(3, "depart", 5).to_dict() == \
        {"slot": 3, "kind": "depart", "device": 5}
    assert Event(3, "depart", 5, "energy_depleted").to_dict()["cause"] == \
        "energy_depleted"


# --------------------------------------------------------------------------
# the two-timescale controller (NumPy paths, bit for bit)
# --------------------------------------------------------------------------

def _ctl(ref, n=14, **skw):
    kw = dict(rounds=4, epoch_len=2, cluster_size=4, saa_samples=2,
              saa_gibbs_iters=6, gibbs_iters=15, cuts=(1, 2, 3), seed=2)
    kw.update(skw)
    rcfg = ref.channel.NetworkCfg(n_devices=n, n_subcarriers=2 * n)
    tcfg = NetworkCfg(n_devices=n, n_subcarriers=2 * n)
    rc = ref.sim_controller.TwoTimescaleController(
        ref.profile.lenet_profile(), rcfg, 16, 1, ref.configs.SimCfg(**kw))
    tc = tctl.TwoTimescaleController(PROF, tcfg, 16, 1, SimCfg(**kw))
    return rc, tc, rcfg, tcfg


def _net(n, seed):
    from repro_torch.core.channel import device_means, sample_network
    cfg = NetworkCfg(n_devices=n, n_subcarriers=2 * n)
    mu = device_means(cfg, seed)
    return mu, sample_network(cfg, *mu, np.random.default_rng(seed + 50))


def _same_plan(a, b):
    assert a.v == b.v and a.stale == b.stale and a.latency == b.latency
    assert a.global_clusters() == b.global_clusters()
    np.testing.assert_array_equal(a.ids, b.ids)
    assert len(a.xs) == len(b.xs)
    for x, y in zip(a.xs, b.xs):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("slot", [0, 4])
def test_select_cut_seeded_matches_reference(ref, chains, slot):
    rc, tc, _, _ = _ctl(ref, gibbs_chains=chains)
    (mu_f, mu_snr), _ = _net(14, slot)
    rv, rmeans = rc.select_cut(mu_f, mu_snr, slot)
    tv, tmeans = tc.select_cut(mu_f, mu_snr, slot)
    assert tv == rv == tc.v == rc.v
    np.testing.assert_array_equal(tmeans, rmeans)


@pytest.mark.parametrize("chains", [1, 2])
def test_select_cut_draws_matches_reference(ref, chains):
    """The ``draws=`` path (the fleet oracle's): J sampled nets from the
    eta normals, best-of-chains per cell, left-to-right accumulation."""
    rc, tc, _, _ = _ctl(ref, gibbs_chains=chains)
    (mu_f, mu_snr), _ = _net(14, 1)
    u = np.random.default_rng(5)
    J, S = 2, 6
    draws = {"eta": u.standard_normal((J, 2, 14)),
             "gibbs": [[(u.random(14), u.random((S, 5)))
                        for _ in range(chains)] for _ in range(J)]}
    rv, rmeans = rc.select_cut(mu_f, mu_snr, 0, draws=draws)
    tv, tmeans = tc.select_cut(mu_f, mu_snr, 0, draws=draws)
    assert tv == rv
    np.testing.assert_array_equal(tmeans, rmeans)


@pytest.mark.parametrize("mode,chains", [("flat", 1), ("flat", 4),
                                         ("bucketed", 1), ("bucketed", 4)])
def test_plan_slot_matches_reference(ref, mode, chains):
    """Flat (looped chains=1, lockstep multichain at 4) and bucketed
    (several buckets at bucket_size 6) plans: identical decisions and
    bit-equal latencies."""
    rc, tc, _, _ = _ctl(ref, n=17, gibbs_chains=chains, plan_mode=mode,
                        bucket_size=6)
    _, net = _net(17, 3)
    ids = np.arange(100, 117)
    rc.v = tc.v = 2
    for slot in (0, 5):
        _same_plan(tc.plan_slot(net, ids, slot), rc.plan_slot(net, ids, slot))


def test_plan_slot_draws_and_repair_match_reference(ref):
    """The ``draws=`` plan (best of the given chains), then a mid-round
    repair that drops one device from one cluster and a whole cluster."""
    rc, tc, _, _ = _ctl(ref, n=13)
    _, net = _net(13, 8)
    ids = np.arange(13) * 3
    rc.v = tc.v = 3
    u = np.random.default_rng(2)
    draws = [(u.random(13), u.random((12, 5))) for _ in range(3)]
    tplan = tc.plan_slot(net, ids, 1, draws=draws)
    rplan = rc.plan_slot(net, ids, 1, draws=draws)
    _same_plan(tplan, rplan)
    gone = [tplan.global_clusters()[0][1]] + tplan.global_clusters()[2]
    _same_plan(tc.repair(tplan, net, gone), rc.repair(rplan, net, gone))
    assert tc.repair(tplan, net, gone).stale


def test_custom_spectrum_fn_fallback_matches_reference(ref):
    """A custom Alg. 3 takes the looped best-of-R path (chain 0 on the
    flat stream, chain c on ``chain_key``)."""
    kw = dict(gibbs_chains=2, gibbs_iters=8)
    rc, tc, _, _ = _ctl(ref, n=10, **kw)
    rc.spectrum_fn = ref.resource.greedy_spectrum
    from repro_torch.core import resource as tres
    tc.spectrum_fn = tres.greedy_spectrum
    _, net = _net(10, 4)
    rc.v = tc.v = 2
    _same_plan(tc.plan_slot(net, np.arange(10), 3),
               rc.plan_slot(net, np.arange(10), 3))


def test_balanced_sizes_defined_once():
    from repro_torch.sim import batched
    assert tctl.balanced_sizes is batched.balanced_sizes
    assert tctl.balanced_sizes(14, 4) == [4, 4, 3, 3]
    assert tctl.balanced_sizes(0, 4) == []


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

def _records():
    rng = np.random.default_rng(0)
    return [
        {"round": 0, "v": 2, "stale": False, "n_active": 3,
         "ids": np.arange(3), "f": rng.random(3), "rate": rng.random(3),
         "clusters": [[0, 1], [2]], "xs": [np.array([3, 4]), np.array([5])],
         "latency_s": np.float64(1.25), "loss": torch.tensor(0.5).item(),
         "events": [Event(0, "depart", 1).to_dict()], "mystery": 7},
        {"round": 1, "skipped": "no active devices", "events": []},
        {"round": 2, "device": 3, "phase": "fwd", "t_s": 0.01,
         "kind": "qos", "bytes": np.int64(128)},
    ]


def test_trace_lines_equal_reference(ref, tmp_path):
    """The same records give the same JSONL lines in both packages, and
    the typed view round-trips (unknown keys in ``extras``)."""
    paths = []
    for tel, name in ((ttel, "port"), (ref.telemetry, "ref")):
        w = tel.TraceWriter(str(tmp_path / f"{name}.jsonl"), fsync=True)
        for rec in _records():
            w.emit(rec)
        paths.append(w.path)
    a, b = (open(p).read() for p in paths)
    assert a == b and a.count("\n") == 3
    for d in ttel.load_trace(paths[0]):
        typed = ttel.parse_record(d)
        assert typed.to_dict() == d
        assert type(typed).__name__ == type(
            ref.telemetry.parse_record(d)).__name__
    assert ttel.parse_record(json.loads(a.splitlines()[0])).extras == \
        {"mystery": 7}
    assert ttel.jsonable(torch.arange(3)) == [0, 1, 2]


def test_trace_writer_fresh_and_rewrite(tmp_path):
    p = str(tmp_path / "t.jsonl")
    ttel.TraceWriter(p).emit({"round": 0})
    w = ttel.TraceWriter(p, fresh=False)
    w.emit(ttel.RoundRecord(round=1, v=3))
    assert [d["round"] for d in ttel.load_trace(p)] == [0, 1]
    w.rewrite([{"round": 0}])
    assert ttel.load_trace(p) == [{"round": 0}]
    ttel.TraceWriter(p, fresh=True)
    assert ttel.load_trace(p) == []


def test_load_trace_torn_tail_and_corruption(ref, tmp_path):
    """A torn final line is dropped with a warning (as the reference
    does); a malformed line elsewhere raises, torn tail tolerated or
    not."""
    p = tmp_path / "t.jsonl"
    p.write_text('{"round": 0}\n{"round": 1}\n{"round": 2, "v"')
    with pytest.warns(RuntimeWarning, match="torn final"):
        got = ttel.load_trace(str(p))
    with pytest.warns(RuntimeWarning):
        assert got == ref.telemetry.load_trace(str(p))
    assert got == [{"round": 0}, {"round": 1}]
    with pytest.raises(ValueError, match="corrupt trace line 3 of 3"):
        ttel.load_trace(str(p), tolerate_torn_tail=False)
    p.write_text('{"round": 0}\n{"rou\n{"round": 2}\n')
    with pytest.raises(ValueError, match="corrupt trace line 2 of 3"):
        ttel.load_trace(str(p))


# --------------------------------------------------------------------------
# SimEngine
# --------------------------------------------------------------------------

def _engine_cfgs(ref, rounds, cuts, n=12, k=3, **dkw):
    skw = dict(rounds=rounds, epoch_len=3, cluster_size=k, saa_samples=2,
               saa_gibbs_iters=5, gibbs_iters=12, gibbs_chains=2, cuts=cuts,
               seed=1)
    ckw = dict(cluster_size=k, n_clusters=-(-n // k), local_epochs=1,
               batch_per_device=8)
    dkw = dict(dict(rho_snr=0.9, rho_f=0.95, seed=1), **dkw)
    n = dict(n_devices=n, n_subcarriers=2 * n)
    return ((ref.channel.NetworkCfg(**n), ref.sim_dynamics.DynamicsCfg(**dkw),
             ref.configs.SimCfg(**skw), ref.configs.CPSLConfig(**ckw)),
            (NetworkCfg(**n), DynamicsCfg(**dkw), SimCfg(**skw),
             CPSLConfig(**ckw)))


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("loss", "eval")}


def test_sim_engine_decisions_match_reference(ref, tmp_path):
    """``train=False`` over 6 rounds with forced and Bernoulli churn,
    arrivals, the floor and energy: the JSONL lines (decisions, events,
    latencies, SAA means) equal the reference's, and the trace
    recomputes."""
    rc, tc = _engine_cfgs(ref, 6, (2, 3, 4), p_depart=0.08, p_arrive=0.3,
                          min_devices=5, energy_budget_j=4.0,
                          forced_departures={1: (2,), 4: (5, 6)})
    lines = []
    for pkg, cfgs, name in ((ref.sim_engine, rc, "ref"),
                            (None, tc, "port")):
        path = str(tmp_path / f"{name}.jsonl")
        ncfg, dcfg, scfg, ccfg = cfgs
        scfg = scfg.replace(trace_path=path)
        prof = ref.profile.lenet_profile() if pkg else PROF
        cls = pkg.SimEngine if pkg else SimEngine
        kw = {} if pkg else {"device": "cpu"}
        eng = cls("lenet", None, prof, ncfg, dcfg, scfg, ccfg, train=False,
                  **kw)
        _, trace = eng.run()
        lines.append(open(path).read().splitlines())
    assert lines[1] == lines[0]
    recs = [json.loads(x) for x in lines[1]]
    kinds = {e["kind"] for r in recs for e in r["events"]}
    assert {"depart", "arrive"} <= kinds
    assert any(r.get("stale") for r in recs)
    want = recompute_trace_latencies(recs, PROF, tc[0], 8, 1)
    got = np.array([r["latency_s"] for r in recs if not r.get("skipped")])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert [r["round"] for r in eng.timings] == \
        [r["round"] for r in recs if not r.get("skipped")]


def test_device_round_energy_matches_reference(ref):
    _, tc, _, tcfg = _ctl(ref, n=9)
    _, net = _net(9, 2)
    tc.v = 3
    plan = tc.plan_slot(net, np.arange(9) + 20, 0, draws=[
        (np.linspace(0, 1, 9), np.random.default_rng(0).random((5, 5)))])
    rplan = ref.sim_controller.Plan(plan.v, plan.clusters, plan.ids,
                                    plan.xs, plan.latency)
    want = ref.sim_engine.device_round_energy(
        rplan, net, ref.channel.NetworkCfg(n_devices=9, n_subcarriers=18),
        ref.profile.lenet_profile(), 16, 2, 0.8, 0.2)
    assert device_round_energy(plan, net, tcfg, PROF, 16, 2, 0.8,
                               0.2) == want


@pytest.mark.parametrize("fused", [False, True], ids=["looped", "fused"])
def test_sim_engine_training_matches_reference(ref, fused):
    """``train=True`` at a fixed cut for 3 rounds, from the reference's
    first state: identical plans, and the losses and every parameter leaf
    within ``ATOL_PAPER`` (of max(1, |value|)). Two clusters of 4 a round:
    training at the paper's lrs is chaotic, and a 1e-7 difference grows
    past the limit within a few more steps."""
    import jax
    xtr, ytr, _, _ = synthetic_mnist(900, 10, seed=0)
    idx = non_iid_split(ytr, n_devices=8, samples_per_device=60)
    rc, tc = _engine_cfgs(ref, 3, (3,), n=8, k=4,
                          forced_departures={1: (4,)}, min_devices=2)
    rc = rc[:3] + (dataclasses.replace(rc[3], fused_round=fused),)
    tc = tc[:3] + (dataclasses.replace(tc[3], fused_round=fused),)
    reng = ref.sim_engine.SimEngine(
        "lenet", ref.pipeline.CPSLDataset(xtr, ytr, idx, batch=8),
        ref.profile.lenet_profile(), *rc)
    rstate, rtrace = reng.run(jax.random.PRNGKey(4))
    # the reference's first state: SimEngine.run splits its key once
    _, sub = jax.random.split(jax.random.PRNGKey(4))
    rcpsl = ref.cpsl.CPSL(ref.splitting.make_split_model("lenet", 3),
                          dataclasses.replace(rc[3], cut_layer=3))
    state0 = cpsl_state_from_numpy(jax.device_get(rcpsl.init_state(sub)),
                                   "cpu")
    teng = SimEngine("lenet", CPSLDataset(xtr, ytr, idx, batch=8), PROF,
                     *tc, device="cpu")
    tstate, ttrace = teng.run(state=state0)
    assert [_strip(ttel.jsonable(r)) for r in ttrace] == \
        [_strip(ttel.jsonable(r)) for r in rtrace]
    for a, b in zip(rtrace, ttrace):
        assert abs(b["loss"] - a["loss"]) <= ATOL_PAPER * max(1.0,
                                                              abs(a["loss"]))
    assert_state_close(rstate, tstate, atol=ATOL_PAPER)
    assert all(t["train_ms"] > 0 for t in teng.timings)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.core.latency import PartitionBatchJ
    from repro_torch.sim.fleet import SimFleetRunner
    from repro_torch.configs.base import SimFleetCfg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ncfg = NetworkCfg(n_devices=4, n_subcarriers=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimEngine("lenet", None, PROF, ncfg, DynamicsCfg(), SimCfg(),
                  CPSLConfig(), train=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimFleetRunner(PROF, ncfg, DynamicsCfg(), SimFleetCfg(rounds=2))
    net = NetworkState(f=np.full(4, 1e9), rate=np.full(4, 1e6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PartitionBatchJ(2, net, ncfg, PROF, 16, 1, [4], np.arange(4))
