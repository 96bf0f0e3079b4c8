"""Parity of the port's CPSL (``repro_torch.core.cpsl``) with the reference.

The reference runs on the CPU in JAX, the port on the CPU in torch, from
the same state (``convert.cpsl_state_from_numpy`` of the reference's
``init_state``) and the same NumPy batches. What must hold:

- integers bit-exact: the step counter, the rng words, index tables and
  gathered batches;
- float leaves (params, optimizer state, error feedback) within a
  per-leaf tolerance ``atol * max(1, max|leaf|)``: ``STEP_ATOL`` after one
  step, ``ATOL_ROUND`` after two 2x2 rounds, ``ATOL_INT8`` with int8
  uploads, ``ATOL_PAPER`` after the paper-config round. Both packages run
  f32, but XLA and torch order their sums differently, so activations
  differ in the last bits (one step: ~1e-8; two 2x2 rounds: ~1e-7,
  measured). Where one sits within those bits of a ReLU's zero or of a
  max-pool tie, the two packages route its gradient differently, a
  discrete jump that the next steps spread: one paper-config round (6
  steps of 80 samples at the reference's server lr 0.25) ends ~2.7e-4
  apart in the server biases (measured). int8 uploads round
  ``(delta + ef) / scale`` half to even; a value within the last bits of
  a half step lands one quantum (max|delta| / 127) away: ~2e-5
  (measured);
- the round's loss within ``LOSS_RTOL``.

The reference's fused-vs-looped contract (<= 0.3 ULP, ``cpsl.py:369-377``)
is XLA's and does not carry across frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import streams as tstreams, tree
from repro_torch.configs.base import CPSLConfig as TCPSLConfig
from repro_torch.convert import cpsl_state_from_numpy, cpsl_state_to_numpy
from repro_torch.core.cpsl import CPSL as TCPSL
from repro_torch.core.splitting import make_split_model as tmake_split
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import non_iid_split as tnon_iid
from repro_torch.data.synthetic import synthetic_mnist as tsynth

STEP_ATOL = 1e-6
ATOL_ROUND = 1e-6
ATOL_INT8 = 2e-4
ATOL_PAPER = 1e-3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


def _cfg_kw(**kw):
    base = dict(cut_layer=3, n_clusters=2, cluster_size=2, local_epochs=2,
                batch_per_device=4)
    base.update(kw)
    return base


def _both(ref, seed=0, **kw):
    """(reference CPSL, port CPSL, reference state, port state)."""
    kw = _cfg_kw(**kw)
    rc = ref.cpsl.CPSL(ref.splitting.make_split_model(
        "lenet", kw["cut_layer"], conv_impl=kw.get("conv_impl", "direct")),
        ref.configs.CPSLConfig(**kw))
    tc = TCPSL(tmake_split("lenet", kw["cut_layer"],
                           conv_impl=kw.get("conv_impl", "direct")),
               TCPSLConfig(**kw))
    rs = rc.init_state(jax.random.PRNGKey(seed))
    ts = cpsl_state_from_numpy(jax.device_get(rs), "cpu")
    return rc, tc, rs, ts


def _data(n_devices, spd, n_train=600, seed=0):
    xtr, ytr, _, _ = tsynth(n_train, 10, seed=seed)
    idx = tnon_iid(ytr, n_devices=n_devices, samples_per_device=spd,
                   seed=seed)
    return xtr, ytr, idx


def assert_state_close(rs, ts, atol=ATOL_ROUND, skip=()):
    """Per leaf: same path, dtype and shape; ints bit-equal; floats within
    ``atol * max(1, max|leaf|)``."""
    rflat = jax.tree_util.tree_flatten_with_path(jax.device_get(rs))[0]
    tflat = tree.flatten_with_path(ts)
    assert [jax.tree_util.keystr(p) for p, _ in rflat] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tflat]
    for (path, a), (_, b) in zip(rflat, tflat):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in skip):
            continue
        a, b = np.asarray(a), b.detach().cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            tol = atol * max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)


def _run_round_both(ref, rc, tc, rs, ts, xtr, ytr, idx, clusters,
                    seed=0, rnd=0, keep=None):
    ds = tpipe.CPSLDataset(xtr, ytr, idx, batch=rc.ccfg.batch_per_device)
    sizes = np.stack([ds.data_sizes(c) for c in clusters])

    def batch_fn_np(m, l):  # noqa: E741
        return ds.cluster_batch(clusters[m],
                                seed=tpipe.batch_seed(seed, rnd, m, l))

    rs, rm = rc.run_round(
        rs, lambda m, l: jax.tree.map(jnp.asarray, batch_fn_np(m, l)),
        n_clusters=len(clusters), data_sizes=sizes)
    ts, tm = tc.run_round(
        ts, lambda m, l: {k: torch.from_numpy(v)
                          for k, v in batch_fn_np(m, l).items()},
        n_clusters=len(clusters), data_sizes=sizes, keep=keep)
    return rs, rm, ts, tm


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("unroll", [False, True], ids=["grouped", "unrolled"])
def test_fused_step_equals_protocol_step(ref, unroll):
    """In the port, the fused step and the explicit two-phase protocol
    give the same update (as ``tests/test_cpsl.py`` holds the reference
    to)."""
    _, tc, _, ts = _both(ref, cluster_size=4, local_epochs=1,
                         unroll_clients=unroll)
    tp = TCPSL(tc.split, TCPSLConfig(**_cfg_kw(
        cluster_size=4, local_epochs=1, unroll_clients=unroll,
        fused_step=False)))
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(
        rng.normal(size=(4, 4, 28, 28, 1)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 10, (4, 4)).astype(np.int32))}
    a, ma = tc.fused_step_impl(ts, batch)
    b, mb = tp.protocol_step_impl(ts, batch)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused-step", "protocol-step"])
@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_step_matches_reference(ref, fused_step, conv_impl):
    """One step from the same state and batch, K = 3 clients."""
    kw = dict(cluster_size=3, local_epochs=1, fused_step=fused_step,
              conv_impl=conv_impl)
    rc, tc, rs, ts = _both(ref, **kw)
    rng = np.random.default_rng(1)
    batch = {"image": rng.normal(size=(3, 4, 28, 28, 1)).astype(np.float32),
             "label": rng.integers(0, 10, (3, 4)).astype(np.int32)}
    rs, rm = rc.cluster_step(rs, jax.tree.map(jnp.asarray, batch))
    ts, tm = tc.cluster_step(ts, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                              rel=LOSS_RTOL)
    assert_state_close(rs, ts, atol=STEP_ATOL)


def test_microbatch_accumulation_matches_reference(ref):
    rc, tc, rs, ts = _both(ref, cluster_size=2, local_epochs=1,
                           microbatches=2)
    rng = np.random.default_rng(2)
    batch = {"image": rng.normal(size=(2, 4, 28, 28, 1)).astype(np.float32),
             "label": rng.integers(0, 10, (2, 4)).astype(np.int32)}
    rs, rm = rc.cluster_step(rs, jax.tree.map(jnp.asarray, batch))
    ts, tm = tc.cluster_step(ts, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                              rel=LOSS_RTOL)
    assert_state_close(rs, ts, atol=STEP_ATOL)


# --------------------------------------------------------------------------
# FedAvg (eq. 8)
# --------------------------------------------------------------------------

def test_fedavg_weighted_mean(ref):
    rc, tc, rs, ts = _both(ref, cluster_size=3)
    rng = np.random.default_rng(3)
    noise = jax.tree.map(
        lambda t: rng.normal(size=t.shape).astype(np.float32),
        jax.device_get(rs["dev"]))
    rs = dict(rs, dev=jax.tree.map(lambda t, n: t + n, rs["dev"], noise))
    ts = dict(ts, dev=cpsl_state_from_numpy(jax.device_get(rs["dev"]),
                                            "cpu"))
    sizes = np.array([10.0, 30.0, 60.0], np.float32)
    ra = rc.fedavg(rs, sizes)
    ta = tc.fedavg(ts, sizes)
    assert_state_close(ra, ta, atol=1e-6)
    w = sizes / sizes.sum()
    for name, t in tree.flatten_with_path(ta["dev"]):
        src = np.asarray(jax.device_get(rs["dev"])[name[0]][name[1]])
        want = np.tensordot(w.astype(np.float64), src.astype(np.float64),
                            axes=(0, 0))
        for k in range(3):
            np.testing.assert_allclose(t[k].numpy(), want, atol=1e-6)


# --------------------------------------------------------------------------
# rounds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused-step", "protocol-step"])
def test_run_round_2x2_matches_reference(ref, fused_step):
    rc, tc, rs, ts = _both(ref, fused_step=fused_step)
    xtr, ytr, idx = _data(4, 60)
    clusters = [[0, 1], [2, 3]]
    for rnd in range(2):
        rs, rm, ts, tm = _run_round_both(ref, rc, tc, rs, ts, xtr, ytr,
                                         idx, clusters, rnd=rnd)
        assert tm["loss"] == pytest.approx(rm["loss"], rel=LOSS_RTOL)
    assert int(ts["step"]) == 2 * 2 * 2
    assert_state_close(rs, ts)


def test_run_round_paper_config_matches_reference(ref):
    """The paper's N = 30 devices, M = 6 clusters of K = 5, B = 16, one
    round."""
    rc, tc, rs, ts = _both(ref, cut_layer=2, n_clusters=6, cluster_size=5,
                           local_epochs=1, batch_per_device=16)
    xtr, ytr, idx = _data(30, 60, n_train=2000)
    clusters = [list(range(5 * m, 5 * m + 5)) for m in range(6)]
    rs, rm, ts, tm = _run_round_both(ref, rc, tc, rs, ts, xtr, ytr, idx,
                                     clusters)
    assert tm["loss"] == pytest.approx(rm["loss"], rel=LOSS_RTOL)
    assert_state_close(rs, ts, atol=ATOL_PAPER)


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_compressed_uploads_with_error_feedback(ref, method):
    rc, tc, rs, ts = _both(ref, compress_uploads=method, compress_topk=0.25)
    assert "ef" in ts
    xtr, ytr, idx = _data(4, 60)
    clusters = [[0, 1], [2, 3]]
    for rnd in range(2):
        rs, rm, ts, tm = _run_round_both(ref, rc, tc, rs, ts, xtr, ytr,
                                         idx, clusters, rnd=rnd)
        assert tm["loss"] == pytest.approx(rm["loss"], rel=LOSS_RTOL)
    assert_state_close(rs, ts,
                       atol=ATOL_INT8 if method == "int8" else ATOL_ROUND)


def _reference_keep_masks(rng_key, M, K, p):
    """The masks the reference's ``fedavg_impl`` draws, cluster by
    cluster, from the state's key (``cpsl.py:293-298``)."""
    key, out = rng_key, []
    for _ in range(M):
        key, sub = jax.random.split(key)
        keep = np.array(jax.random.bernoulli(sub, 1.0 - p, (K,)))
        keep[0] = True
        out.append(keep)
    return np.stack(out)


def test_straggler_dropout_with_injected_mask(ref):
    """The port takes the reference's keep masks as its (M, K) table; the
    reference also advances its rng at every FedAvg, which the port
    carries unchanged, so ``rng`` is left out of the comparison."""
    rc, tc, rs, ts = _both(ref, cluster_size=3, straggler_dropout=0.5)
    xtr, ytr, idx = _data(6, 60)
    clusters = [[0, 1, 2], [3, 4, 5]]
    keep = _reference_keep_masks(rs["rng"], 2, 3, 0.5)
    assert not keep.all()                 # some client is really dropped
    rs, rm, ts, tm = _run_round_both(ref, rc, tc, rs, ts, xtr, ytr, idx,
                                     clusters, keep=keep)
    assert tm["loss"] == pytest.approx(rm["loss"], rel=LOSS_RTOL)
    assert_state_close(rs, ts, skip=("'rng'",))
    with pytest.raises(ValueError, match="keep table"):
        tc.fedavg(ts)


def test_keep_table_stream():
    """The port's straggler stream is registered beside copies of every
    reference pattern and collides with none, and a keep table never
    drops a cluster's first client."""
    assert tstreams.registry_overlaps() == []
    tc = TCPSL(tmake_split("lenet", 2),
               TCPSLConfig(cluster_size=5, straggler_dropout=0.9))
    t = tc.keep_table(0, 3, 6)
    assert t.shape == (6, 5) and t.dtype == bool
    np.testing.assert_array_equal(t, tc.keep_table(0, 3, 6))
    assert not np.array_equal(t, tc.keep_table(0, 4, 6))


def test_registry_disjoint_from_reference(ref):
    """Every reference tuple pattern is in the port's registry with the
    same key, so the proof above covers the reference's streams."""
    for name, spec in ref.streams.REGISTRY.items():
        if spec.pool != "tuple":
            continue
        mine = tstreams.REGISTRY[name]
        assert [getattr(k, "name", k) for k in mine.key] == \
            [getattr(k, "name", k) for k in spec.key]
        assert [(k.lo, k.hi) for k in mine.key if hasattr(k, "lo")] == \
            [(k.lo, k.hi) for k in spec.key if hasattr(k, "lo")]


# --------------------------------------------------------------------------
# the port's fused round against its looped round
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(fused_step=False),
    dict(unroll_clients=True, compress_uploads="topk"),
    dict(straggler_dropout=0.4, compress_uploads="int8"),
], ids=["fused-step", "protocol-step", "unrolled-topk", "straggler-int8"])
def test_fused_round_matches_looped_round(ref, kw):
    """Batches gathered on the device from the index table, FedAvg at
    each cluster boundary: the same ops in the same order as the looped
    round, so on one device the two agree to the last bit."""
    _, tc, _, ts = _both(ref, cluster_size=3, **kw)
    xtr, ytr, idx = _data(6, 60)
    clusters = [[0, 1, 2], [3, 4, 5]]
    ds = tpipe.CPSLDataset(xtr, ytr, idx, batch=4)
    dsd = tpipe.DeviceResidentDataset.from_dataset(ds, device="cpu")
    s_loop, s_fused = ts, tree.map(lambda t: t.clone(), ts)
    for rnd in range(2):
        keep = (tc.keep_table(0, rnd, 2) if tc.ccfg.straggler_dropout
                else None)
        s_loop, m_loop = tc.run_round(
            s_loop, lambda m, l, r=rnd: {
                k: torch.from_numpy(v) for k, v in ds.cluster_batch(
                    clusters[m], seed=tpipe.batch_seed(0, r, m, l)).items()},
            data_sizes=dsd.cluster_weights(clusters), keep=keep)
        s_fused, m_fused = tc.run_round_fused(
            s_fused, dsd.data, dsd.round_index_table(clusters, 0, rnd, 2),
            dsd.cluster_weights(clusters), keep)
        assert m_loop["loss"] == float(m_fused["loss"])
        assert m_fused["losses"].shape == (4,)
    for a, b in zip(tree.leaves(s_loop), tree.leaves(s_fused)):
        assert torch.equal(a, b)


def test_cpsl_state_round_trips_through_convert(ref):
    rc, _, rs, ts = _both(ref, optimizer="adamw", compress_uploads="topk")
    back = cpsl_state_to_numpy(ts)
    ra = jax.tree_util.tree_structure(jax.device_get(rs))
    assert jax.tree_util.tree_structure(back) == ra
    for a, b in zip(jax.tree.leaves(jax.device_get(rs)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ts["rng"].dtype == torch.uint32 and ts["step"].dtype == torch.int32
