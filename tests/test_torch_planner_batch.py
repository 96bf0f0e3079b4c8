"""Decision identity of the port's replicated planner
(``repro_torch.sim.batched``) with the reference's ``repro.sim.batched``,
on seeded networks, on the CPU.

Everything here is NumPy on both sides, so every decision is held
bit-for-bit: cluster lists, spectrum allocations, latencies, per-chain
histories, SAA's v* and per-cut means. Against the port's own looped
planner (``core.resource``), chain 0 replays ``gibbs_clustering`` and the
batched SAA at ``chains=1`` gives the looped SAA's v* and means.
"""
import numpy as np
import pytest

import _cpsl_ref
from repro_torch.core import resource as tres
from repro_torch.core.channel import NetworkCfg as TNetworkCfg
from repro_torch.core.channel import device_means as tdevice_means
from repro_torch.core.channel import sample_network as tsample_network
from repro_torch.core.profile import lenet_profile as tlenet_profile
from repro_torch.sim import batched as tb

TPROF = tlenet_profile()


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


def _nets(ref, n, seed):
    """The same seeded network in both packages."""
    rcfg = ref.channel.NetworkCfg(n_devices=n, n_subcarriers=2 * n)
    tcfg = TNetworkCfg(n_devices=n, n_subcarriers=2 * n)
    rnet = ref.channel.sample_network(
        rcfg, *ref.channel.device_means(rcfg, seed),
        np.random.default_rng(seed))
    tnet = tsample_network(tcfg, *tdevice_means(tcfg, seed),
                           np.random.default_rng(seed))
    np.testing.assert_array_equal(tnet.f, rnet.f)
    np.testing.assert_array_equal(tnet.rate, rnet.rate)
    return (rnet, rcfg), (tnet, tcfg)


def _same_plan(a, b):
    """(clusters, xs, lat) identical, bit for bit."""
    assert [[int(d) for d in c] for c in a[0]] == \
        [[int(d) for d in c] for c in b[0]]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a[2] == b[2]


@pytest.mark.parametrize("seed,v", [(0, 1), (3, 2), (7, 5)])
def test_greedy_spectrum_batched_matches_reference(ref, seed, v):
    (rnet, rcfg), (tnet, tcfg) = _nets(ref, 10, seed)
    devices = [1, 4, 6, 9]
    rx, rl = ref.batched.greedy_spectrum_batched(
        v, devices, rnet, rcfg, ref.profile.lenet_profile(), 16, 1)
    tx, tl = tb.greedy_spectrum_batched(v, devices, tnet, tcfg, TPROF, 16, 1)
    np.testing.assert_array_equal(tx, rx)
    assert tl == rl
    # and the port's looped Alg. 3
    lx, ll = tres.greedy_spectrum(v, devices, tnet, tcfg, TPROF, 16, 1)
    np.testing.assert_array_equal(tx, lx)
    assert tl == ll


@pytest.mark.parametrize("chains", [1, 4])
@pytest.mark.parametrize("seed,iters", [(0, 40), (5, 70)])
def test_multichain_matches_reference(ref, chains, seed, iters):
    """Every chain's plan, its tracked history, the winner and the
    per-chain latencies."""
    (rnet, rcfg), (tnet, tcfg) = _nets(ref, 12, seed)
    kw = dict(iters=iters, seed=seed, chains=chains, track=True, full=True)
    r = ref.batched.gibbs_clustering_multichain(
        2, rnet, rcfg, ref.profile.lenet_profile(), 16, 1, 4, 3, **kw)
    t = tb.gibbs_clustering_multichain(2, tnet, tcfg, TPROF, 16, 1, 4, 3,
                                       **kw)
    assert isinstance(t, tb.MultiChainResult)
    _same_plan((r.clusters, r.xs, r.latency), (t.clusters, t.xs, t.latency))
    assert t.best_chain == r.best_chain
    np.testing.assert_array_equal(t.chain_latencies, r.chain_latencies)
    for a, b in zip(r.chain_results, t.chain_results):
        _same_plan(a, b)
    assert t.hists == r.hists


def test_multichain_chain0_replays_gibbs():
    """Chain 0 is the port's looped ``gibbs_clustering`` at the same seed,
    trajectory included; best-of-R never plans worse."""
    tcfg = TNetworkCfg(n_devices=12, n_subcarriers=24)
    net = tsample_network(tcfg, *tdevice_means(tcfg, 4),
                          np.random.default_rng(4))
    single = tres.gibbs_clustering(2, net, tcfg, TPROF, 16, 1, 4, 3,
                                   iters=60, seed=4, track=True)
    res = tb.gibbs_clustering_multichain(2, net, tcfg, TPROF, 16, 1, 4, 3,
                                         iters=60, seed=4, chains=3,
                                         track=True, full=True)
    assert res.hists[0] == single[3]
    _same_plan(single[:3], res.chain_results[0])
    assert res.latency <= single[2]


def test_multichain_uneven_sizes_match_reference(ref):
    (rnet, rcfg), (tnet, tcfg) = _nets(ref, 11, 2)
    kw = dict(iters=50, seed=2, chains=3, sizes=[4, 4, 3])
    r = ref.batched.gibbs_clustering_multichain(
        3, rnet, rcfg, ref.profile.lenet_profile(), 16, 1, 3, 4, **kw)
    t = tb.gibbs_clustering_multichain(3, tnet, tcfg, TPROF, 16, 1, 3, 4,
                                       **kw)
    _same_plan(r, t)


@pytest.mark.parametrize("n_buckets,chains,topk", [(1, 2, 0), (3, 2, 0),
                                                   (2, 1, 2)])
def test_hierarchical_matches_reference(ref, n_buckets, chains, topk):
    (rnet, rcfg), (tnet, tcfg) = _nets(ref, 18, 6)
    kw = dict(iters=30, seed=6, chains=chains, n_buckets=n_buckets,
              spectrum_topk=topk, full=True)
    r = ref.batched.hierarchical_gibbs_clustering(
        2, rnet, rcfg, ref.profile.lenet_profile(), 16, 1, 3, **kw)
    t = tb.hierarchical_gibbs_clustering(2, tnet, tcfg, TPROF, 16, 1, 3,
                                         **kw)
    assert isinstance(t, tb.HierarchicalResult)
    _same_plan((r.clusters, r.xs, r.latency), (t.clusters, t.xs, t.latency))
    assert len(t.buckets) == len(r.buckets) == n_buckets
    for a, b in zip(r.buckets, t.buckets):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.bucket_latencies, r.bucket_latencies)


def test_hierarchical_one_bucket_equals_flat():
    """One bucket: the flat multichain planner at balanced sizes."""
    tcfg = TNetworkCfg(n_devices=14, n_subcarriers=28)
    net = tsample_network(tcfg, *tdevice_means(tcfg, 1),
                          np.random.default_rng(1))
    sizes = tb.balanced_sizes(14, 4)
    assert sizes == [4, 4, 3, 3]
    h = tb.hierarchical_gibbs_clustering(2, net, tcfg, TPROF, 16, 1, 4,
                                         iters=40, seed=1, chains=2,
                                         n_buckets=1)
    f = tb.gibbs_clustering_multichain(2, net, tcfg, TPROF, 16, 1,
                                       len(sizes), max(sizes), iters=40,
                                       seed=1, chains=2, sizes=sizes)
    _same_plan(h, f)


@pytest.mark.parametrize("chains", [1, 2])
def test_saa_batched_matches_reference(ref, chains):
    kw = dict(B=16, L=1, n_clusters=3, cluster_size=4, n_samples=2,
              gibbs_iters=12, seed=5, chains=chains, cuts=[1, 2, 4])
    rv, rm = ref.batched.saa_cut_selection_batched(
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(n_devices=12),
        **kw)
    tv, tm = tb.saa_cut_selection_batched(TPROF, TNetworkCfg(n_devices=12),
                                          **kw)
    assert tv == rv
    np.testing.assert_array_equal(tm, rm)
    if chains == 1:
        # the port's looped SAA: same v* and means, bit for bit
        kw.pop("chains")
        lv, lm = tres.saa_cut_selection(TPROF, TNetworkCfg(n_devices=12),
                                        **kw)
        assert tv == lv
        np.testing.assert_array_equal(tm, lm)


def test_bucket_chain_stream():
    """Bucket 0 is the flat chain stream; other buckets are registered
    and disjoint from every other pattern."""
    from repro_torch import streams as tstreams
    assert tstreams.registry_overlaps() == []
    assert "bucket_chain" in tstreams.REGISTRY
    a = tstreams.bucket_chain_rng(3, 0, 2).random(4)
    np.testing.assert_array_equal(a, tstreams.chain_rng(3, 2).random(4))
    b = tstreams.bucket_chain_rng(3, 1, 2).random(4)
    np.testing.assert_array_equal(
        b, np.random.default_rng((3, tstreams.BUCKET_TAG, 1, 2)).random(4))


def test_bucket_chain_stream_matches_reference(ref):
    for bucket, chain in [(0, 0), (0, 3), (2, 1)]:
        np.testing.assert_array_equal(
            ref.streams.bucket_chain_rng(9, bucket, chain).random(5),
            tb.streams.bucket_chain_rng(9, bucket, chain).random(5))


def test_trainer_gibbs_mc_matches_reference(ref, tmp_path):
    """``CPSLTrainer(resource_mgmt="gibbs-mc")``: the same decisions as the
    reference trainer for 2 rounds; the port's run prices each round at
    its plan, chain 0's plan is the ``"gibbs"`` plan, and best-of-4 never
    plans worse."""
    import torch

    from repro_torch.configs.base import CPSLConfig as TCPSLConfig
    from repro_torch.core.cpsl import CPSL as TCPSL
    from repro_torch.core.splitting import make_split_model as tmake_split
    from repro_torch.data import pipeline as tpipe
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
    from repro_torch.train import trainer as ttrainer

    xtr, ytr, _, _ = synthetic_mnist(400, 20, seed=0)
    idx = non_iid_split(ytr, n_devices=6, samples_per_device=40, seed=0)
    ccfg = dict(cut_layer=3, n_clusters=2, cluster_size=3, local_epochs=1,
                batch_per_device=4)

    def tcfg(ns, kind, d):
        return ns.TrainerCfg(rounds=2, ckpt_every=2,
                             ckpt_dir=str(tmp_path / d), resource_mgmt=kind,
                             gibbs_iters=25, gibbs_chains=4, async_ckpt=False)

    rt = ref.trainer.CPSLTrainer(
        ref.cpsl.CPSL(ref.splitting.make_split_model("lenet", 3),
                      ref.configs.CPSLConfig(**ccfg)),
        ref.pipeline.CPSLDataset(xtr, ytr, idx, batch=4),
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(n_devices=6),
        tcfg(ref.trainer, "gibbs-mc", "ref"))

    def port(kind):
        return ttrainer.CPSLTrainer(
            TCPSL(tmake_split("lenet", 3), TCPSLConfig(**ccfg)),
            tpipe.CPSLDataset(xtr, ytr, idx, batch=4), TPROF,
            TNetworkCfg(n_devices=6), tcfg(ttrainer, kind, kind),
            device="cpu")

    tt, tg = port("gibbs-mc"), port("gibbs")
    plans = []
    for rnd in range(2):
        rp, tp = rt._plan_round(3, rnd), tt._plan_round(3, rnd)
        _same_plan(rp, tp)
        gp = tg._plan_round(3, rnd)
        assert tp[2] <= gp[2]
        net = tsample_network(tt.ncfg, tt.mu_f, tt.mu_snr,
                              tb.streams.trainer_round_rng(0, rnd))
        full = tb.gibbs_clustering_multichain(
            3, net, tt.ncfg, TPROF, 4, 1, 2, 3, iters=25, seed=rnd,
            chains=4, full=True)
        _same_plan(full.chain_results[0], gp)
        plans.append(tp)
    tt.run(torch.Generator().manual_seed(0))
    assert [h["sim_latency_s"] for h in tt.history] == [p[2] for p in plans]
    assert all(h["plan_s"] > 0 for h in tt.history)
