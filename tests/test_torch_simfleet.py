"""The port's episode-fleet simulator (``repro_torch.sim.fleet``) and its
tensor cost engine (``core.latency.PartitionBatchJ``) against the
reference's ``repro.sim.fleet``, on the CPU.

- ``PartitionBatchJ`` against the NumPy ``PartitionBatch`` and against
  the reference's jnp ``PartitionBatchJ`` on randomized (v, sizes, draws)
  grids, to the reference's own 1e-12.
- ``SimFleetRunner.run`` on a small grid (N = 12, C = 15, K in {3, 4},
  T = 8, 2 seeds, all three policies, SAA cuts, Bernoulli churn with the
  floor, reserve arrivals, energy depletion, ``cost_chunk`` 0 and 2,
  ``policy_overrides``, seed-dict ``perms``) against the reference's
  ``run()``: the reference draws its AR(1) innovations with threefry,
  which torch cannot reproduce, so they are copied into the port's
  runner; every other pre-drawn array is asserted bit-equal. Every
  traced decision array is identical, every float within 1e-9 relative;
  the same holds against the port's own looped ``run_reference``.
- ties (exact-tie networks), the recompute oracle, the capacity guard,
  explicit schedules over ``forced_departures``, a small
  ``train_curves``.

The reference is imported inside a module-scoped fixture, under
``tests/_cpsl_ref.py::reference()``.
"""
import importlib

import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import streams
from repro_torch.configs.base import CPSLConfig, SimFleetCfg
from repro_torch.core import latency as tlt
from repro_torch.core.channel import (NetworkCfg, NetworkState, device_means,
                                      sample_network)
from repro_torch.core.latency import PartitionBatch, PartitionBatchJ
from repro_torch.core.profile import lenet_profile
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.sim import fleet as tf
from repro_torch.sim.dynamics import DynamicsCfg
from repro_torch.sim.engine import recompute_trace_latencies

PROF = lenet_profile()
RTOL = 1e-9
INNOVATIONS = ("_eta_f0", "_eta_s0", "_eps_f", "_eps_s")
PREDRAWN = ("_mu_f", "_mu_snr", "_u_dep", "_u_arr", "_gkey", "_gprop",
            "_saa_eta", "_saa_key", "_saa_prop", "_perm_rank", "_depart",
            "_arrive", "_energy0", "_v0", "_Ktgt")
DECISIONS = ("dev", "mask", "csize", "xs", "v", "active", "n_active")
FLOATS = ("latency", "cluster_latency", "energy", "f", "rate")


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as m:
        m.sim_fleet = importlib.import_module("repro.sim.fleet")
        m.sim_dynamics = importlib.import_module("repro.sim.dynamics")
        yield m


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# --------------------------------------------------------------------------
# tensor cost engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("seed,sizes", [(0, [3, 2, 2]), (1, [4, 3, 3]),
                                        (2, [2, 2, 2])])
def test_partition_batch_j_matches_numpy_and_reference(ref, seed, sizes,
                                                       chunk):
    """Per-replica cuts, unequal sizes, stacked draws: the port agrees
    with the NumPy evaluator and with the reference's jnp port."""
    rng = np.random.default_rng(seed)
    N = int(sum(sizes))
    R, S = 6, 3
    ncfg = NetworkCfg(n_devices=N, n_subcarriers=2 * N)
    mu_f, mu_snr = device_means(ncfg, seed)
    nets = [sample_network(ncfg, mu_f, mu_snr, rng) for _ in range(S)]
    snet = NetworkState(f=np.stack([n.f for n in nets]),
                        rate=np.stack([n.rate for n in nets]))
    v = rng.integers(1, PROF.n_cuts + 1, size=R)
    rows = rng.integers(0, S, size=R)
    dev = np.stack([rng.permutation(N) for _ in range(R)])
    xs = rng.integers(1, 7, size=(R, N))
    pb = PartitionBatch(v, snet, ncfg, PROF, 16, 2, sizes, dev,
                        net_rows=rows)
    pbj = PartitionBatchJ(v, snet, ncfg, PROF, 16, 2, sizes, dev,
                          net_rows=rows, chunk_size=chunk, device="cpu")
    rpbj = ref.latency.PartitionBatchJ(
        v, snet, ref.channel.NetworkCfg(n_devices=N, n_subcarriers=2 * N),
        ref.profile.lenet_profile(), 16, 2, sizes, dev, net_rows=rows)
    got = pbj.cluster_latencies(xs)
    np.testing.assert_allclose(got, pb.cluster_latencies(xs), rtol=1e-12)
    np.testing.assert_allclose(got, rpbj.cluster_latencies(xs), rtol=1e-12)
    np.testing.assert_allclose(pbj.latencies(xs), pb.latencies(xs),
                               rtol=1e-12)
    np.testing.assert_allclose(pbj.latencies(xs), rpbj.latencies(xs),
                               rtol=1e-12)


@pytest.mark.parametrize("physical", [False, True])
def test_partition_batch_j_broadcast_and_scalar_cut(physical):
    """One device row against P candidate allocations (the
    BatchedClusterEvaluator shape), scalar cut, physical_gradients; the
    chunked path is bit-identical to the unchunked one."""
    rng = np.random.default_rng(7)
    ncfg = NetworkCfg(n_devices=5, n_subcarriers=10)
    net = sample_network(ncfg, *device_means(ncfg, 7), rng)
    xs = rng.integers(1, 6, size=(17, 5))
    pb = PartitionBatch(2, net, ncfg, PROF, 16, 1, [5], np.arange(5),
                        physical_gradients=physical)
    kw = dict(physical_gradients=physical, device="cpu")
    pbj = PartitionBatchJ(2, net, ncfg, PROF, 16, 1, [5], np.arange(5), **kw)
    np.testing.assert_allclose(pbj.latencies(xs), pb.latencies(xs),
                               rtol=1e-12)
    chunked = PartitionBatchJ(2, net, ncfg, PROF, 16, 1, [5], np.arange(5),
                              chunk_size=5, **kw)
    np.testing.assert_array_equal(chunked.cluster_latencies(xs),
                                  pbj.cluster_latencies(xs))
    f32 = PartitionBatchJ(2, net, ncfg, PROF, 16, 1, [5], np.arange(5),
                          dtype=np.float32, **kw)
    np.testing.assert_allclose(f32.latencies(xs), pb.latencies(xs),
                               rtol=1e-5)


def test_cost_engine_tensors_stay_float64_on_their_device():
    from repro_torch.core.latency import _cluster_latency_j, \
        _sum_left_to_right
    g = torch.Generator().manual_seed(0)
    fd = 1e8 + 1e9 * torch.rand(2, 3, 4, generator=g, dtype=torch.float64)
    rd = 1e6 + 1e7 * torch.rand(2, 3, 4, generator=g, dtype=torch.float64)
    xs = torch.randint(1, 5, (2, 3, 4), generator=g, dtype=torch.int32)
    mask = torch.ones(2, 3, 4, dtype=torch.bool)
    mask[1, 2, 1:] = False
    csize = mask.sum(-1)
    cst = {k: torch.as_tensor(getattr(PROF, k)[2], dtype=torch.float64)
           for k in tlt._CST_KEYS}
    D = _cluster_latency_j(cst, fd, rd, xs, mask, csize, B=16, L=2, C=12,
                           f_server_kappa=1e11, kappa=1.0)
    assert D.dtype == torch.float64 and D.shape == (2, 3)
    ncfg = NetworkCfg(n_devices=4, n_subcarriers=12)
    for e, m in ((0, 0), (1, 2)):
        k = int(csize[e, m])
        net = NetworkState(f=fd[e, m, :k].numpy(), rate=rd[e, m, :k].numpy())
        want = tlt.cluster_latency(3, list(range(k)), xs[e, m, :k].numpy(),
                                   net, ncfg, PROF, 16, 2)
        assert float(D[e, m]) == pytest.approx(want, rel=1e-14)
    tot = _sum_left_to_right(D)
    assert float(tot[0]) == float(D[0, 0]) + float(D[0, 1]) + float(D[0, 2])


# --------------------------------------------------------------------------
# SimFleetRunner against the reference
# --------------------------------------------------------------------------

GRID = dict(rounds=8, seeds=(0, 1), policies=("equal", "greedy",
                                              "proposed"),
            cluster_sizes=(3, 4), cuts=(2,), epoch_len=3, gibbs_iters=6,
            gibbs_chains=2, saa_samples=2, saa_gibbs_iters=4,
            saa_cuts=(1, 2, 3), n_reserve=2, min_devices_floor=True)
DYN = dict(rho_snr=0.9, rho_f=0.95, seed=0, p_depart=0.08, p_arrive=0.3,
           min_devices=4, energy_budget_j=12.0,
           forced_departures={2: (1,), 4: (0, 5)})
NET = dict(n_devices=12, n_subcarriers=15)

CASES = {
    "chunk0": dict(),
    "chunk2": dict(grid=dict(cost_chunk=2)),
    "no-floor": dict(grid=dict(min_devices_floor=False, cost_chunk=2),
                     dyn=dict(energy_budget_j=8.0)),
    "overrides-perms": dict(
        grid=dict(policies=("greedy",), saa_cuts=None),
        kw=dict(policy_overrides=["proposed", "equal", "greedy", "greedy"],
                perms={0: np.random.default_rng(3).permutation(12),
                       1: np.random.default_rng(4).permutation(12)},
                layout_modes=[0, 0, 1, 0])),
}


def _pair(ref, case):
    """(reference runner, port runner) for a CASES entry, the reference's
    innovations copied in."""
    c = CASES[case]
    grid, dyn = dict(GRID, **c.get("grid", {})), dict(DYN, **c.get("dyn",
                                                                   {}))
    kw = c.get("kw", {})
    rr = ref.sim_fleet.SimFleetRunner(
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(**NET),
        ref.sim_dynamics.DynamicsCfg(**dyn), ref.configs.SimFleetCfg(**grid),
        **kw)
    tr = tf.SimFleetRunner(PROF, NetworkCfg(**NET), DynamicsCfg(**dyn),
                           SimFleetCfg(**grid), device="cpu", **kw)
    return rr, tr


@pytest.fixture(scope="module")
def runs(ref):
    """Each case's reference and port results, computed once."""
    out = {}
    for case in CASES:
        rr, tr = _pair(ref, case)
        own = [np.array(getattr(tr, k)) for k in INNOVATIONS]
        for k in INNOVATIONS:
            setattr(tr, k, getattr(rr, k).copy())
        out[case] = (rr, tr, rr.run(), tr.run(), own)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_predrawn_arrays_bit_equal(runs, case):
    """Every pre-drawn array but the innovations is the reference's bit
    for bit; the port's own innovations come from its registered
    stream, one (T + 1, 2, N) draw per episode seed."""
    rr, tr, _, _, own = runs[case]
    for k in PREDRAWN:
        a = getattr(rr, k, None)
        if a is None:
            assert getattr(tr, k, None) is None, k
            continue
        np.testing.assert_array_equal(getattr(tr, k), a, err_msg=k)
    assert tr.specs == rr.specs
    eta_f0 = own[0]
    for e, sp in enumerate(tr.specs):
        d = streams.fleet_innovations_rng(0, sp["seed"]).standard_normal(
            (tr.T + 1, 2, tr.N))
        np.testing.assert_array_equal(eta_f0[e], d[0, 0])
        np.testing.assert_array_equal(own[2][:, e], d[1:, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_run_matches_reference(runs, case):
    """Every traced decision array identical, every float within 1e-9
    relative of the reference's ``run()``; the failing episode and slot
    are reported."""
    rr, tr, rres, tres, _ = runs[case]
    for k in DECISIONS:
        a, b = rres["trace"][k], tres["trace"][k]
        assert a.shape == b.shape, k
        bad = np.argwhere((a != b).reshape(a.shape[0], a.shape[1], -1)
                          .any(-1))
        assert not len(bad), f"{k} differs at (episode, slot) {bad[:5]}"
    for k in FLOATS:
        assert _rel(tres["trace"][k], rres["trace"][k]) <= RTOL, k
    got = np.array([ep["sim_time_s"] for ep in tres["episodes"]])
    want = np.array([ep["sim_time_s"] for ep in rres["episodes"]])
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_run_matches_own_run_reference(runs, case):
    """The port's looped NumPy oracle (its ``TwoTimescaleController``
    ``draws=`` hooks on the proposed rows) makes the same decisions."""
    _, tr, _, tres, _ = runs[case]
    looped = tr.run_looped()
    assert _rel(tres["trace"]["latency"], looped["latency"]) <= RTOL
    for e in range(tr.E):
        recs = tf.fleet_trace_records(tres, e)
        for t in range(tr.T):
            want = looped["records"][e][t]
            assert recs[t]["v"] == want["v"], (e, t)
            assert recs[t]["clusters"] == want["clusters"], (e, t)
            for a, b in zip(recs[t]["xs"], want["xs"]):
                np.testing.assert_array_equal(a, b, err_msg=str((e, t)))


def test_fleet_grid_exercises_every_path(runs):
    """The grid really churns, re-selects cuts, repairs and depletes."""
    _, tr, _, tres, _ = runs["chunk0"]
    trc = tres["trace"]
    prows = list(tr._prows)
    assert (trc["v"][prows] != 2).any()          # SAA moved off the spec cut
    assert (trc["v"][list(tr._grows)] == 2).all()
    assert (trc["n_active"][:, 1:] > trc["n_active"][:, :-1]).any()
    assert (trc["n_active"] < 12).any()
    assert (trc["energy"] == 0.0).any()
    assert (trc["n_active"] >= 4).all()
    sums = np.where(trc["mask"], trc["xs"], 0).sum(-1)
    assert (sums[trc["csize"] > 0] == 15).all()


def test_fleet_recompute_oracle(runs):
    rr, tr, _, tres, _ = runs["chunk2"]
    want = recompute_trace_latencies(tres, PROF, tr.ncfg, 16, 1)
    assert want.shape == tres["trace"]["latency"].shape
    np.testing.assert_allclose(tres["trace"]["latency"], want, rtol=1e-12)
    np.testing.assert_array_equal(
        want, tf.recompute_fleet_latencies(tres, PROF, tr.ncfg, 16, 1))


def test_fleet_exact_ties_match_reference(ref):
    """Identical devices (no spread, no fading noise): every greedy step
    ties across the cluster and every layout sort ties, so the decisions
    rest on first-min argmin, stable argsort and lowest-gid arrival."""
    net = dict(NET, homogeneous=True, f_sigma=0.0, snr_sigma_db=0.0)
    grid = dict(GRID, cuts=(3,))
    dyn = dict(DYN, energy_budget_j=0.0)
    kw = dict(layout_modes=[1] * 12)
    rr = ref.sim_fleet.SimFleetRunner(
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(**net),
        ref.sim_dynamics.DynamicsCfg(**dyn), ref.configs.SimFleetCfg(**grid),
        **kw)
    tr = tf.SimFleetRunner(PROF, NetworkCfg(**net), DynamicsCfg(**dyn),
                           SimFleetCfg(**grid), device="cpu", **kw)
    for k in INNOVATIONS:
        setattr(tr, k, getattr(rr, k).copy())
    a, b = rr.run()["trace"], tr.run()["trace"]
    assert (b["f"] == b["f"][0, 0, 0]).all()
    for k in DECISIONS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert _rel(b["latency"], a["latency"]) <= RTOL
    # greedy on identical devices: every step ties, slot 0 takes it all
    rows = list(tr._grows)
    full = b["csize"][rows] == 4
    xs = b["xs"][rows][full]
    assert len(xs) and (xs[:, 1:] == 1).all()


def test_greedy_xs_first_min_on_ties():
    """All candidates tie at every step (a grant to a non-straggler
    leaves the max where it was): the first minimum, slot 0, takes every
    grant, exactly as in ``core.resource.greedy_spectrum``."""
    from repro_torch.core import resource as tres
    ncfg = NetworkCfg(n_devices=4, n_subcarriers=10)
    net = NetworkState(f=np.full(4, 5e8), rate=np.full(4, 2e6))
    want, _ = tres.greedy_spectrum(3, [0, 1, 2, 3], net, ncfg, PROF, 16, 1)
    cst = {k: torch.as_tensor(getattr(PROF, k)[2], dtype=torch.float64)
           for k in tlt._CST_KEYS}
    got = tf._greedy_xs(cst, torch.full((1, 1, 4), 5e8, dtype=torch.float64),
                        torch.full((1, 1, 4), 2e6, dtype=torch.float64),
                        torch.ones(1, 1, 4, dtype=torch.bool),
                        torch.tensor([[4]]), C=10, B=16, L=1,
                        f_server_kappa=1e11, kappa=1.0)
    np.testing.assert_array_equal(got[0, 0].numpy(), want)
    np.testing.assert_array_equal(want, [7, 1, 1, 1])


def test_depart_slots_win_over_forced_departures(ref):
    """An explicit schedule wins outright (a later explicit slot stays
    reachable), in both packages."""
    dyn = dict(seed=0, forced_departures={2: (1,)})
    grid = dict(rounds=6, seeds=(0,), policies=("equal",), cuts=(3,),
                cluster_sizes=(3,))
    depart = np.full(12, 6)
    depart[1] = 4
    tr = tf.SimFleetRunner(PROF, NetworkCfg(**NET), DynamicsCfg(**dyn),
                           SimFleetCfg(**grid), depart_slots=depart,
                           device="cpu")
    rr = ref.sim_fleet.SimFleetRunner(
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(**NET),
        ref.sim_dynamics.DynamicsCfg(**dyn), ref.configs.SimFleetCfg(**grid),
        depart_slots=depart)
    np.testing.assert_array_equal(tr._depart, rr._depart)
    res = tr.run()
    for t, rec in enumerate(tf.fleet_trace_records(res, 0)):
        assert (1 in [d for c in rec["clusters"] for d in c]) == (t < 4)


def test_capacity_guard():
    grid = SimFleetCfg(rounds=4, cluster_sizes=(3,), policies=("equal",))
    with pytest.raises(ValueError, match="layout capacity"):
        tf.SimFleetRunner(PROF, NetworkCfg(**NET), DynamicsCfg(), grid,
                          n_clusters=3, device="cpu")
    depart = np.where(np.arange(12) < 3, 0, 4)
    r = tf.SimFleetRunner(PROF, NetworkCfg(**NET), DynamicsCfg(), grid,
                          n_clusters=3, depart_slots=depart, device="cpu")
    assert r.M == 3 and (r.run()["trace"]["n_active"] == 9).all()


def test_train_curves_runs_the_fleet():
    """A static greedy grid coupled to ``CPSL.run_fleet`` on the CPU:
    one loss per round per episode, finite, merged with the priced
    curves; the padded layouts are the slot-0 plans."""
    ncfg = NetworkCfg(n_devices=8, n_subcarriers=12)
    fcfg = SimFleetCfg(rounds=2, seeds=(0, 1), policies=("greedy",),
                       cluster_sizes=(4,), cuts=(3,), batch_per_device=4)
    runner = tf.SimFleetRunner(PROF, ncfg, DynamicsCfg(seed=0), fcfg,
                               device="cpu")
    res = runner.run()
    xtr, ytr, xte, yte = synthetic_mnist(400, 40, seed=0)
    ccfg = CPSLConfig(batch_per_device=4, local_epochs=1)
    out = runner.train_curves(res, xtr, ytr, ccfg, xte=xte, yte=yte,
                              samples_per_device=40, eval_every=1)
    assert len(out) == 2
    for rep, ep in zip(out, res["episodes"]):
        assert rep["sim_time_s"] == ep["sim_time_s"]
        assert len(rep["loss"]) == 2 and np.isfinite(rep["loss"]).all()
        assert len(rep["acc"]) == 2 and rep["eval_rounds"] == [0, 1]
    churn = tf.SimFleetRunner(PROF, ncfg, DynamicsCfg(p_depart=0.1),
                              fcfg, device="cpu")
    with pytest.raises(AssertionError, match="static scenario"):
        churn.train_curves(churn.run(), xtr, ytr, ccfg)
