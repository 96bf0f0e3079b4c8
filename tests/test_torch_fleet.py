"""Parity of the port's experiment fleet with the reference, on the CPU:
``CPSL.run_training_fused`` (R rounds in one call, eval on the device),
``CPSL.run_fleet`` (E replicas batched), ``data.pipeline.fleet_plan``,
``train.trainer.FleetRunner`` and ``FLTrainer``.

Both packages start from the reference's states (``init_state`` /
``init_fleet_state`` through ``convert``) and the same NumPy tables. What
must hold:

- against the reference: index tables, eq.-8 weights, masks and simulated
  latencies bit-equal; integer leaves (step counters, rng words) bit-equal;
  float leaves per leaf (``tests/test_torch_cpsl.py``: XLA and torch sum
  in other orders) within ``ATOL_ROUND`` for the 2x2 curves and fleets,
  and ``ATOL_PAPER`` for the padded grid, whose 12 steps on clusters of
  one device (4 samples a server step) drift further (1.07e-6 at R = 3,
  measured); losses within ``LOSS_RTOL``;
- against the port's own runs: a curve equals R looped ``run_round_fused``
  calls bit for bit (the same ops in the same order); an lr scale of 0.5
  equals the lr baked in, and a padded slot changes no output, both bit
  for bit; on one CPU thread a homogeneous fleet's replica is bit-equal
  to its solo curve: the device pass's grouped convolution over E*K
  groups computes each group as the solo pass's over K does, the server
  pass over E takes ``apply_range``'s layout
  (``lenet.apply_range_replicas``), and FedAvg's batched product equals
  the solo ``tensordot`` (with several threads the work splits by the
  tensors' sizes and sums in another order). A padded replica's loss and
  gradients reduce over its padded rows too, and a shared device model
  runs one convolution of E groups where the solo run has one model's, so
  those replicas are held to their solo runs after one round, per leaf
  within ``ATOL_PAPER``, and over R rounds with integer leaves bit-equal:
  this training amplifies a last-bit gap ~30x a step once an activation
  sits within it of a ReLU zero or a max-pool tie (2.8e-5 -> 8.3e-4 in
  three steps, measured), while a wrong mask or broadcast moves a leaf by
  a whole lr-scaled update in the first step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from test_torch_cpsl import (ATOL_PAPER, ATOL_ROUND, LOSS_RTOL,
                             assert_state_close)
from repro_torch import streams, tree
from repro_torch.configs.base import CPSLConfig as TCPSLConfig
from repro_torch.configs.base import FleetConfig as TFleetConfig
from repro_torch.convert import cpsl_state_from_numpy, cpsl_state_to_numpy
from repro_torch.core.channel import NetworkCfg as TNetworkCfg
from repro_torch.core.cpsl import CPSL as TCPSL
from repro_torch.core.cpsl import FLTrainer as TFLTrainer
from repro_torch.core.profile import lenet_profile as tlenet_profile
from repro_torch.core.splitting import make_split_model as tmake_split
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
from repro_torch.models import lenet as tlenet
from repro_torch.train.trainer import FleetRunner as TFleetRunner

M, K, B, L, R = 2, 2, 4, 2, 3
CLUSTERS = [[0, 1], [2, 3]]
CCFG = dict(cut_layer=3, n_clusters=M, cluster_size=K, local_epochs=L,
            batch_per_device=B)

XTR, YTR, XTE, YTE = synthetic_mnist(400, 50, seed=0)


def _shards(seed):
    return non_iid_split(YTR, n_devices=4, samples_per_device=60, seed=seed)


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DSD = tpipe.DeviceResidentDataset(XTR, YTR, _shards(0), B,
                                  eval_images=XTE, eval_labels=YTE,
                                  device="cpu")


@pytest.fixture
def dsd():
    return DSD


def _tcpsl(**kw):
    ccfg = TCPSLConfig(**dict(CCFG, **kw))
    return TCPSL(tmake_split("lenet", ccfg.cut_layer,
                             conv_impl=ccfg.conv_impl), ccfg)


def _rcpsl(ref, **kw):
    ccfg = ref.configs.CPSLConfig(**dict(CCFG, **kw))
    return ref.cpsl.CPSL(ref.splitting.make_split_model(
        "lenet", ccfg.cut_layer, conv_impl=ccfg.conv_impl), ccfg)


def _init(seed=0, **kw):
    """A port state from ``init_state(generator)`` at ``seed``."""
    return _tcpsl(**kw).init_state(torch.Generator().manual_seed(seed))


def _pick(states, e):
    return tree.map(lambda t: t[e], states)


def _assert_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_replica_close(solo, states, e, atol=ATOL_ROUND):
    """Replica ``e`` of a fleet against its solo run: integer leaves
    bit-equal, floats within ``atol * max(1, max|leaf|)`` (skipped when
    ``atol`` is None); the padded client rows of a fleet's dev stacks are
    cut to the solo's."""
    for (path, a), (_, b) in zip(tree.flatten_with_path(solo),
                                 tree.flatten_with_path(states), strict=True):
        b = b[e]
        if a.shape != b.shape:
            b = b[:a.shape[0]]
        if a.dtype.is_floating_point:
            if atol is None:
                assert bool(torch.isfinite(b).all()), f"replica {e} {path}"
                continue
            tol = atol * max(1.0, float(a.abs().max()))
            err = float((a - b).abs().max())
            assert err <= tol, f"replica {e} at {path}: {err} > {tol}"
        else:
            assert torch.equal(a, b), f"replica {e} at {path}"


def _padded_plan(seeds=(0, 1)):
    """Cluster sizes (1, 2) over 4 devices: (M, K) = (4, 1) and (2, 2),
    padded to (4, 2) with both masks."""
    layouts, shards, sd = [], [], []
    for size in (1, 2):
        for s in seeds:
            layouts.append([list(range(m * size, (m + 1) * size))
                            for m in range(4 // size)])
            shards.append(_shards(s))
            sd.append(s)
    return layouts, shards, sd


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["homogeneous", "padded"])
def test_fleet_plan_bit_equal_to_reference(ref, kind):
    if kind == "homogeneous":
        seeds = [0, 1, 2]
        layouts, shards = [CLUSTERS] * 3, [_shards(s) for s in seeds]
    else:
        layouts, shards, seeds = _padded_plan()
    rp = ref.pipeline.fleet_plan(shards, B, layouts, seeds, R, L)
    tp = tpipe.fleet_plan(shards, B, layouts, seeds, R, L)
    for name in ("idx", "weights", "cluster_mask", "client_mask"):
        a, b = getattr(rp, name), getattr(tp, name)
        if a is None:
            assert b is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert tp.layouts == rp.layouts and tp.seeds == rp.seeds
    assert tp.n_replicas == rp.n_replicas
    assert (kind == "homogeneous") == (tp.cluster_mask is None)
    if kind == "padded":
        # real rows are the replica's own round tables; padded slots hold
        # index 0 and weight 0
        for e, (lay, sh, s) in enumerate(zip(layouts, shards, seeds)):
            Me, Ke = len(lay), len(lay[0])
            for r in range(R):
                np.testing.assert_array_equal(
                    tp.idx[e, r, :Me, :, :Ke],
                    tpipe.round_index_table(sh, B, lay, s, r, L))
            assert (tp.weights[e][~tp.client_mask[e]] == 0).all()
            assert (tp.idx[e][:, ~tp.cluster_mask[e]] == 0).all()


def test_fleet_config_matches_reference(ref):
    kw = dict(rounds=4, seeds=(0, 1), cluster_sizes=(5, 10),
              lr_scales=(0.5, 1.0, 2.0), eval_every=2)
    a, b = ref.configs.FleetConfig(**kw), TFleetConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.n_replicas == b.n_replicas == 12
    assert b.replace(seeds=(3,)).n_replicas == 6
    assert dataclasses.asdict(ref.configs.FleetConfig()) == \
        dataclasses.asdict(TFleetConfig())


# --------------------------------------------------------------------------
# the training curve
# --------------------------------------------------------------------------

def test_training_curve_matches_reference(ref, dsd):
    rc, tc = _rcpsl(ref), _tcpsl()
    rs0 = rc.init_state(jax.random.PRNGKey(0))
    ts = cpsl_state_from_numpy(jax.device_get(rs0), "cpu")
    w = dsd.cluster_weights(CLUSTERS)
    idx = dsd.training_index_table(CLUSTERS, 0, R, L)
    rdata = {k: jnp.asarray(v.numpy()) for k, v in dsd.data.items()}
    reval = {k: jnp.asarray(v.numpy()) for k, v in dsd.eval_data.items()}
    rs, rm = rc.run_training_fused(rs0, rdata, idx, w, eval_data=reval,
                                   eval_every=2)
    ts, tm = tc.run_training_fused(ts, dsd.data, idx, w,
                                   eval_data=dsd.eval_data, eval_every=2)
    assert_state_close(rs, ts)
    assert tm["losses"].shape == (R, M * L) and tm["loss"].shape == (R,)
    np.testing.assert_allclose(tm["losses"].numpy(),
                               np.asarray(rm["losses"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=LOSS_RTOL)
    assert tm["eval_rounds"] == rm["eval_rounds"] == [1, 2]
    np.testing.assert_allclose(tm["eval"]["acc"].numpy(),
                               np.asarray(rm["eval"]["acc"]), atol=1e-6)
    np.testing.assert_allclose(tm["eval"]["loss"].numpy(),
                               np.asarray(rm["eval"]["loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(fused_step=False, conv_impl="im2col"),
    dict(straggler_dropout=0.4, compress_uploads="topk",
         compress_topk=0.25),
], ids=["fused-step", "protocol-im2col", "straggler-topk"])
def test_training_curve_equals_looped_rounds(dsd, kw):
    """``run_training_fused`` is R ``run_round_fused`` calls in one: the
    same ops in the same order, so the states and losses are equal bit
    for bit."""
    cp = _tcpsl(**kw)
    w = dsd.cluster_weights(CLUSTERS)
    keep = (np.stack([cp.keep_table(0, r, M) for r in range(R)])
            if cp.ccfg.straggler_dropout else None)
    s_loop, looped = _init(**kw), []
    for r in range(R):
        s_loop, m = cp.run_round_fused(
            s_loop, dsd.data, dsd.round_index_table(CLUSTERS, 0, r, L), w,
            None if keep is None else keep[r])
        looped.append(m["losses"])
    s_curve, mc = cp.run_training_fused(
        _init(**kw), dsd.data, dsd.training_index_table(CLUSTERS, 0, R, L),
        w, keep=keep)
    _assert_equal(s_loop, s_curve)
    assert torch.equal(mc["losses"], torch.stack(looped))
    assert torch.equal(mc["loss"], torch.stack(looped).mean(-1))


def test_lr_scale_matches_baked_lr(dsd):
    """An lr scale of 0.5 as a tensor equals the halved lr written into
    the config: the float products are exact, so the states are
    bit-identical."""
    w = dsd.cluster_weights(CLUSTERS)
    idx = dsd.training_index_table(CLUSTERS, 0, R, L)
    s_scaled, m_scaled = _tcpsl().run_training_fused(
        _init(), dsd.data, idx, w, lr_scale=0.5)
    baked = _tcpsl(lr_device=0.05 * 0.5, lr_server=0.25 * 0.5)
    s_baked, m_baked = baked.run_training_fused(_init(), dsd.data, idx, w)
    _assert_equal(s_scaled, s_baked)
    assert torch.equal(m_scaled["loss"], m_baked["loss"])


def test_in_loop_eval_matches_host_eval(dsd):
    """The eval curve the call carries equals host-side evaluation of the
    exported params (``lenet.accuracy`` and the mean NLL) at the same
    rounds."""
    cp = _tcpsl()
    w = dsd.cluster_weights(CLUSTERS)
    state, host_acc, host_loss = _init(), [], []
    for r in range(R):
        state, _ = cp.run_round_fused(
            state, dsd.data, dsd.round_index_table(CLUSTERS, 0, r, L), w)
        if r in cp.eval_rounds(R, 2):
            params, _ = cp.export_params(state)
            host_acc.append(tlenet.accuracy(params, XTE, YTE))
            logits = tlenet.forward(params, torch.from_numpy(XTE))
            host_loss.append(float(tlenet.nll(
                logits, torch.from_numpy(YTE)).mean()))
    _, mc = cp.run_training_fused(
        _init(), dsd.data, dsd.training_index_table(CLUSTERS, 0, R, L), w,
        eval_data=dsd.eval_data, eval_every=2)
    assert mc["eval_rounds"] == [1, 2]
    np.testing.assert_allclose(mc["eval"]["acc"].numpy(), host_acc,
                               atol=1e-6)
    np.testing.assert_allclose(mc["eval"]["loss"].numpy(), host_loss,
                               rtol=LOSS_RTOL)


def test_curve_asserts_reference_contract(dsd):
    cp = _tcpsl(scan_rounds=True)
    idx = dsd.training_index_table(CLUSTERS, 0, R, L)
    with pytest.raises(AssertionError, match="divide rounds"):
        cp.run_training_fused(_init(), dsd.data, idx, eval_data=dsd.eval_data,
                              eval_every=2)
    with pytest.raises(AssertionError, match="needs eval_data"):
        cp.run_training_fused(_init(), dsd.data, idx, eval_every=3)
    with pytest.raises(AssertionError):
        _tcpsl(local_epochs=1).run_training_fused(_init(), dsd.data, idx)


# --------------------------------------------------------------------------
# the fleet
# --------------------------------------------------------------------------

def test_fleet_matches_reference(ref, dsd):
    """A homogeneous 3-replica fleet with unequal lr scales, both packages
    from the reference's ``init_fleet_state``."""
    seeds = [0, 1, 2]
    plan = tpipe.fleet_plan([_shards(s) for s in seeds], B,
                            [CLUSTERS] * 3, seeds, R, L)
    lrs = np.array([1.0, 0.5, 1.5], np.float32)
    rc, tc = _rcpsl(ref), _tcpsl()
    rstates = rc.init_fleet_state(seeds)
    tstates = cpsl_state_from_numpy(jax.device_get(rstates), "cpu")
    assert tstates["step"].shape == (3,) and tstates["rng"].shape == (3, 2)
    rdata = {k: jnp.asarray(v.numpy()) for k, v in dsd.data.items()}
    rstates, rm = rc.run_fleet(rstates, rdata, plan.idx, plan.weights,
                               lr_scale=lrs)
    tstates, tm = tc.run_fleet(tstates, dsd.data, plan.idx, plan.weights,
                               lr_scale=lrs)
    assert_state_close(rstates, tstates)
    assert tm["losses"].shape == (3, R, M * L) and tm["loss"].shape == (3, R)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=LOSS_RTOL)


def test_padded_fleet_matches_reference(ref, dsd):
    layouts, shards, seeds = _padded_plan()
    plan = tpipe.fleet_plan(shards, B, layouts, seeds, R, 1)
    rc = _rcpsl(ref, n_clusters=4, cluster_size=2, local_epochs=1)
    tc = _tcpsl(n_clusters=4, cluster_size=2, local_epochs=1)
    rstates = rc.init_fleet_state(seeds)
    tstates = cpsl_state_from_numpy(jax.device_get(rstates), "cpu")
    rdata = {k: jnp.asarray(v.numpy()) for k, v in dsd.data.items()}
    kw = dict(cluster_mask=plan.cluster_mask, client_mask=plan.client_mask)
    rstates, rm = rc.run_fleet(rstates, rdata, plan.idx, plan.weights, **kw)
    tstates, tm = tc.run_fleet(tstates, dsd.data, plan.idx, plan.weights,
                               **kw)
    assert_state_close(rstates, tstates, atol=ATOL_PAPER)
    np.testing.assert_array_equal(np.isnan(tm["losses"].numpy()),
                                  np.isnan(np.asarray(rm["losses"])))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=LOSS_RTOL)


def _fleet_vs_solo(kw, seeds, rounds, lrs=None, keep_fn=None,
                   layouts=None):
    """A fleet over ``seeds`` (homogeneous 2x2 unless ``layouts`` pads
    it) and each replica's solo ``run_training_fused`` at its own layout,
    both with eval every 2 rounds. Returns ``(states, metrics, solos)``
    with ``solos[e] = (state, metrics)``."""
    if layouts is None:
        layouts = [CLUSTERS] * len(seeds)
    shards = [_shards(s) for s in seeds]
    plan = tpipe.fleet_plan(shards, B, layouts, seeds, rounds,
                            kw.get("local_epochs", L))
    Mp, Kp = plan.idx.shape[2], plan.idx.shape[4]
    cp = _tcpsl(**dict(kw, n_clusters=Mp, cluster_size=Kp))
    keep = None if keep_fn is None else keep_fn(cp, plan)
    states = tree.map(lambda *ts: torch.stack(ts),
                      *[_init(s, **dict(kw, cluster_size=Kp))
                        for s in seeds])
    states, mf = cp.run_fleet(
        states, DSD.data, plan.idx, plan.weights, lr_scale=lrs,
        eval_data=DSD.eval_data, eval_every=2,
        cluster_mask=plan.cluster_mask, client_mask=plan.client_mask,
        keep=keep)
    solos = []
    for e, (seed, lay) in enumerate(zip(seeds, layouts)):
        Me, Ke = len(lay), len(lay[0])
        kw_e = dict(kw, n_clusters=Me, cluster_size=Ke)
        solos.append(_tcpsl(**kw_e).run_training_fused(
            _init(seed, **kw_e), DSD.data, plan.idx[e, :, :Me, :, :Ke],
            plan.weights[e, :Me, :Ke],
            lr_scale=None if lrs is None else lrs[e],
            eval_data=DSD.eval_data, eval_every=2,
            keep=None if keep is None else keep[e, :, :Me, :Ke]))
    return states, mf, solos


def _assert_fleet_tracks_solos(kw, seeds, lrs=None, keep_fn=None,
                               layouts=None, atol=None):
    """Each replica against its solo run over R rounds, with eval: every
    leaf bit-equal (``atol`` None), or per leaf within ``atol`` after one
    round and integer leaves bit-equal after R."""
    rounds = [R] if atol is None else [1, R]
    for rnd in rounds:
        states, mf, solos = _fleet_vs_solo(kw, seeds, rnd, lrs, keep_fn,
                                           layouts)
        assert mf["eval_rounds"] == solos[0][1]["eval_rounds"]
        for e, (solo, ms) in enumerate(solos):
            if atol is None or rnd == 1:
                np.testing.assert_allclose(mf["eval"]["acc"][e].numpy(),
                                           ms["eval"]["acc"].numpy(),
                                           atol=1e-6)
            if atol is None:
                # the eval pass runs one model's convolutions in the solo
                # run and E groups in the fleet: held to LOSS_RTOL
                np.testing.assert_allclose(mf["eval"]["loss"][e].numpy(),
                                           ms["eval"]["loss"].numpy(),
                                           rtol=LOSS_RTOL)
                _assert_equal(solo, _pick(states, e))
                assert torch.equal(mf["loss"][e], ms["loss"])
            elif rnd == 1:
                _assert_replica_close(solo, states, e, atol)
                np.testing.assert_allclose(mf["loss"][e].numpy(),
                                           ms["loss"].numpy(), rtol=1e-4)
            else:
                _assert_replica_close(solo, states, e, atol=None)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(fused_step=False),
    dict(conv_impl="im2col", optimizer="adamw"),
    dict(compress_uploads="int8", optimizer="momentum", momentum=0.9,
         lr_device=0.01, lr_server=0.05),
    dict(compress_uploads="topk", compress_topk=0.25, microbatches=2),
], ids=["fused-step", "protocol-step", "im2col-adamw", "int8-momentum",
        "topk-microbatches"])
def test_fleet_replicas_match_solo_runs(one_thread, kw):
    """Replica e (its own seed, shard table and lr scale) is its solo
    curve at seed e, bit for bit; the unequal lr scales catch a wrong
    broadcast of a per-replica scalar against the stacked leaves."""
    _assert_fleet_tracks_solos(kw, [0, 1, 2],
                               lrs=np.array([1.0, 0.5, 0.25], np.float32))


def test_fleet_with_stragglers_matches_solo_runs(one_thread):
    """Straggler dropout in a fleet: each replica's (R, M, K) keep tables
    from its own seed; each replica is its own solo run, bit for bit."""
    def keep_fn(cp, plan):
        keep = np.stack([np.stack([cp.keep_table(s, r, M)
                                   for r in range(plan.idx.shape[1])])
                         for s in plan.seeds])
        assert not keep.all()
        return keep

    _assert_fleet_tracks_solos(dict(straggler_dropout=0.5), [3, 4],
                               keep_fn=keep_fn)


def test_fleet_shared_device_model_tracks_solo_runs():
    _assert_fleet_tracks_solos(dict(share_device_params=True,
                                    local_epochs=1), [0, 1],
                               lrs=np.array([1.0, 0.5], np.float32),
                               atol=ATOL_PAPER)


def _padded_run(cp, plan, idx, weights):
    states = tree.map(lambda *ts: torch.stack(ts),
                      *[_init(s, n_clusters=4, cluster_size=2,
                              local_epochs=1) for s in plan.seeds])
    return cp.run_fleet(states, DSD.data, idx, weights,
                        cluster_mask=plan.cluster_mask,
                        client_mask=plan.client_mask,
                        eval_data=DSD.eval_data, eval_every=2)


@pytest.mark.parametrize("default_weights", [False, True],
                         ids=["shard-weights", "uniform-weights"])
def test_padded_slots_never_contribute(default_weights):
    """Perturbing every padded slot's index entries leaves every output
    bit-identical — also when the caller leaves ``weights`` at the uniform
    default, where the client mask must still keep padded slots out of
    FedAvg."""
    layouts, shards, seeds = _padded_plan()
    plan = tpipe.fleet_plan(shards, B, layouts, seeds, R, 1)
    cp = _tcpsl(n_clusters=4, cluster_size=2, local_epochs=1)
    weights = None if default_weights else plan.weights
    s_a, m_a = _padded_run(cp, plan, plan.idx, weights)
    poked = plan.idx.copy()
    pad = ~np.broadcast_to(plan.client_mask[:, None, :, None, :, None],
                           poked.shape)
    assert pad.sum() > 0
    poked[pad] = (poked[pad] + 7) % len(XTR)
    s_b, m_b = _padded_run(cp, plan, poked, weights)
    _assert_equal(s_a, s_b)
    for k in ("losses", "loss"):
        np.testing.assert_array_equal(m_a[k].numpy(), m_b[k].numpy())
    for k in ("acc", "loss"):
        assert torch.equal(m_a["eval"][k], m_b["eval"][k])


def test_padded_metrics_masked_and_replicas_track_solo():
    """Padded cluster slots report NaN losses and real ones are finite;
    each replica tracks the solo run of its own unpadded layout."""
    layouts, shards, seeds = _padded_plan()
    plan = tpipe.fleet_plan(shards, B, layouts, seeds, R, 1)
    cp = _tcpsl(n_clusters=4, cluster_size=2, local_epochs=1)
    _, mf = _padded_run(cp, plan, plan.idx, plan.weights)
    losses = mf["losses"].numpy().reshape(4, R, 4)
    assert np.isnan(losses[2:, :, 2:]).all()       # size 2: 2 real clusters
    assert np.isfinite(losses[2:, :, :2]).all()
    assert np.isfinite(losses[:2]).all()           # size 1: 4 real clusters
    assert np.isfinite(mf["loss"].numpy()).all()
    _assert_fleet_tracks_solos(dict(local_epochs=1), seeds, layouts=layouts,
                               atol=ATOL_PAPER)


def test_fleet_state_round_trips_through_convert(ref):
    """An E-stacked reference fleet state crosses to the port and back
    unchanged; ``init_fleet_state`` stacks the port's ``init_state``."""
    rc = _rcpsl(ref, optimizer="momentum", compress_uploads="int8")
    rstates = jax.device_get(rc.init_fleet_state([0, 3]))
    ts = cpsl_state_from_numpy(rstates, "cpu")
    back = cpsl_state_to_numpy(ts)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(rstates)
    for a, b in zip(jax.tree.leaves(rstates), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tc = _tcpsl(optimizer="momentum", compress_uploads="int8")
    fleet = tc.init_fleet_state([0, 3], device="cpu")
    assert [p for p, _ in tree.flatten_with_path(fleet)] == \
        [p for p, _ in tree.flatten_with_path(ts)]
    for e, seed in enumerate([0, 3]):
        _assert_equal(_pick(fleet, e),
                      tc.init_state(streams.model_generator(seed, "cpu")))


def test_fleet_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fcfg = TFleetConfig(rounds=1, seeds=(0,), cluster_sizes=(2,),
                        n_devices=4, samples_per_device=60)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TFleetRunner(XTR, YTR, fcfg, TCPSLConfig(**CCFG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tcpsl().init_fleet_state([0])
    runner = TFleetRunner(XTR, YTR, fcfg, TCPSLConfig(**CCFG), device="cpu")
    assert runner.dsd.data["image"].device.type == "cpu"


# --------------------------------------------------------------------------
# FleetRunner and FLTrainer
# --------------------------------------------------------------------------

def test_fleet_runner_matches_reference(ref):
    """The padded grid of cluster sizes (1, 2) over 4 devices, two seeds:
    the same grid, tables and simulated latencies (bit-equal), and the
    curves from the reference's initial states."""
    kw = dict(rounds=R, seeds=(0, 1), cluster_sizes=(1, 2), n_devices=4,
              samples_per_device=60, eval_every=2)
    ckw = dict(CCFG, n_clusters=4, local_epochs=1)
    rr = ref.trainer.FleetRunner(
        XTR, YTR, ref.configs.FleetConfig(**kw),
        ref.configs.CPSLConfig(**ckw), xte=XTE, yte=YTE,
        prof=ref.profile.lenet_profile(),
        ncfg=ref.channel.NetworkCfg(n_devices=4))
    tr = TFleetRunner(XTR, YTR, TFleetConfig(**kw), TCPSLConfig(**ckw),
                      xte=XTE, yte=YTE, prof=tlenet_profile(),
                      ncfg=TNetworkCfg(n_devices=4), device="cpu")
    assert tr.specs == rr.specs
    assert (tr.ccfg.n_clusters, tr.ccfg.cluster_size) == (4, 2)
    for name in ("idx", "weights", "cluster_mask", "client_mask"):
        np.testing.assert_array_equal(getattr(tr.plan, name),
                                      getattr(rr.plan, name))
    init = jax.device_get(rr.cpsl.init_fleet_state(rr.plan.seeds))
    rout = rr.run()
    tout = tr.run(cpsl_state_from_numpy(init, "cpu"))
    assert tout["n_replicas"] == rout["n_replicas"] == 4
    assert tout["eval_rounds"] == rout["eval_rounds"] == [1, 2]
    assert tout["wall_s"] > 0
    for a, b in zip(rout["replicas"], tout["replicas"]):
        for k in ("seed", "cluster_size", "n_clusters", "lr_scale"):
            assert a[k] == b[k]
        assert b["sim_time_s"] == a["sim_time_s"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["acc"], a["acc"], atol=1e-6)
        np.testing.assert_allclose(b["eval_loss"], a["eval_loss"],
                                   rtol=LOSS_RTOL)
    assert_state_close(rr.states, tr.states, atol=ATOL_PAPER)


def test_fl_trainer_round_matches_reference(ref):
    """The FL comparator: N = 3 full LeNets, 2 local SGD steps each, then
    the mean, from the reference's initial params."""
    N, S = 3, 2
    rf = ref.cpsl.FLTrainer(ref.lenet.loss_fn, ref.lenet.init, N, lr=0.1,
                            local_steps=S)
    tf = TFLTrainer(tlenet.loss_fn_clients, tlenet.init, N, lr=0.1,
                    local_steps=S)
    rs = rf.init_state(jax.random.PRNGKey(0))
    ts = {"params": cpsl_state_from_numpy(
        jax.device_get(rs["params"]), "cpu")}
    rng = np.random.default_rng(0)
    pick = rng.integers(0, len(XTR), (N, S, B))
    batches = {"image": XTR[pick], "label": YTR[pick]}
    for _ in range(2):
        rs, rl = rf.round(rs, jax.tree.map(jnp.asarray, batches))
        ts, tl = tf.round(ts, {k: torch.from_numpy(v)
                               for k, v in batches.items()})
        assert float(tl) == pytest.approx(float(rl), rel=LOSS_RTOL)
    assert_state_close(rs, ts)
    for leaf in tree.leaves(ts):
        assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[0],
                                                             leaf[2])
    fresh = tf.init_state(torch.Generator().manual_seed(0))
    assert fresh["params"]["CONV1"]["w"].shape == (N, 3, 3, 1, 32)
