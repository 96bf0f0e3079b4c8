"""Parity of the port's control plane, trainer, checkpoints and launcher
with the reference (``repro.train.trainer``, ``repro.core.resource``,
``repro.data.pipeline``, ``repro.checkpoint.checkpointer``), on the CPU.

Integers and planner decisions are bit-exact: cluster lists, spectrum
allocations, simulated latencies, SAA's v* and per-cut means, index
tables, gathered batches, checkpoint payload bytes. Trained float leaves
are held to ``ATOL`` per leaf (see ``tests/test_torch_cpsl.py`` for why
the packages drift by ~1e-7 over a few small rounds) and losses to
``LOSS_RTOL``.
"""
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs.base import CPSLConfig as TCPSLConfig
from repro_torch.convert import cpsl_state_from_numpy
from repro_torch.core import resource as tres
from repro_torch.core.channel import NetworkCfg as TNetworkCfg
from repro_torch.core.cpsl import CPSL as TCPSL
from repro_torch.core.profile import lenet_profile as tlenet_profile
from repro_torch.core.splitting import make_split_model as tmake_split
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import non_iid_split as tnon_iid
from repro_torch.data.synthetic import synthetic_mnist as tsynth
from repro_torch.launch import train as tlaunch
from repro_torch.train import trainer as ttrainer

ATOL = 1e-6
LOSS_RTOL = 1e-5
CCFG = dict(cut_layer=3, n_clusters=2, cluster_size=2, local_epochs=1,
            batch_per_device=4)


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = tsynth(600, 50, seed=0)
    idx = tnon_iid(ytr, n_devices=4, samples_per_device=60, seed=0)
    return xtr, ytr, idx


def _trainers(ref, data, tmp_path, port_ccfg=(), **tkw):
    """(reference trainer, port trainer); ``port_ccfg`` adds CPSLConfig
    fields on the port's side only."""
    xtr, ytr, idx = data
    tcfg = dict(rounds=2, ckpt_every=1, resource_mgmt="gibbs",
                gibbs_iters=20, async_ckpt=False)
    tcfg.update(tkw)
    rcp = ref.cpsl.CPSL(ref.splitting.make_split_model("lenet", 3),
                        ref.configs.CPSLConfig(**CCFG))
    tcp = TCPSL(tmake_split("lenet", 3),
                TCPSLConfig(**CCFG, **dict(port_ccfg)))
    rt = ref.trainer.CPSLTrainer(
        rcp, ref.pipeline.CPSLDataset(xtr, ytr, idx, batch=4),
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(n_devices=4),
        ref.trainer.TrainerCfg(ckpt_dir=str(tmp_path / "ref"), **tcfg))
    tt = ttrainer.CPSLTrainer(
        tcp, tpipe.CPSLDataset(xtr, ytr, idx, batch=4), tlenet_profile(),
        TNetworkCfg(n_devices=4),
        ttrainer.TrainerCfg(ckpt_dir=str(tmp_path / "port"), **tcfg),
        device="cpu")
    return rt, tt


# --------------------------------------------------------------------------
# control plane
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gibbs", "gibbs-mc", "heuristic", "random",
                                  "fixed"])
def test_plan_round_decision_identical(ref, data, tmp_path, kind):
    rt, tt = _trainers(ref, data, tmp_path, resource_mgmt=kind)
    for rnd in range(3):
        rc, rx, rl = rt._plan_round(3, rnd)
        tc, tx, tl = tt._plan_round(3, rnd)
        assert [list(map(int, c)) for c in rc] == \
            [list(map(int, c)) for c in tc]
        for a, b in zip(rx, tx):
            np.testing.assert_array_equal(a, b)
        assert tl == rl


def test_saa_cut_selection_decision_identical(ref):
    """Alg. 2 at the paper's N = 30, M = 6, K = 5, B = 16."""
    kw = dict(B=16, L=1, n_clusters=6, cluster_size=5, n_samples=2,
              gibbs_iters=15, seed=3)
    rv, rm = ref.resource.saa_cut_selection(
        ref.profile.lenet_profile(), ref.channel.NetworkCfg(n_devices=30),
        **kw)
    tv, tm = tres.saa_cut_selection(tlenet_profile(),
                                    TNetworkCfg(n_devices=30), **kw)
    assert tv == rv
    np.testing.assert_array_equal(tm, rm)


@pytest.mark.parametrize("which", ["lenet", "paper", "qwen2-0.5b",
                                   "mamba2-2.7b"])
def test_cut_profiles_equal_reference(ref, which):
    from repro.configs import registry as rregistry
    from repro_torch.configs import registry as tregistry
    from repro_torch.core import profile as tprofile
    if which == "lenet":
        a, b = ref.profile.lenet_profile(), tprofile.lenet_profile()
    elif which == "paper":
        a = ref.profile.paper_constants_profile()
        b = tprofile.paper_constants_profile()
    else:
        a = ref.profile.lm_profile(rregistry.get(which), seq=128)
        b = tprofile.lm_profile(tregistry.get(which), seq=128)
    for k in ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB", "gamma_sF",
              "gamma_sB"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def test_index_tables_and_batches_bit_equal(ref, data):
    xtr, ytr, idx = data
    clusters = [[0, 2], [3, 1]]
    want = ref.pipeline.round_index_table(idx, 4, clusters, 7, 2, 2)
    got = tpipe.round_index_table(idx, 4, clusters, 7, 2, 2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    rds = ref.pipeline.CPSLDataset(xtr, ytr, idx, batch=4)
    tds = tpipe.CPSLDataset(xtr, ytr, idx, batch=4)
    dsd = tpipe.DeviceResidentDataset.from_dataset(tds, device="cpu")
    np.testing.assert_array_equal(
        dsd.training_index_table(clusters, 7, 3, 2)[2], want)
    np.testing.assert_array_equal(dsd.cluster_weights(clusters),
                                  rds.data_sizes([0, 2])[None].repeat(2, 0))
    for m in range(2):
        for l in range(2):  # noqa: E741
            seed = tpipe.batch_seed(7, 2, m, l)
            assert seed == ref.pipeline.batch_seed(7, 2, m, l)
            rb = rds.cluster_batch(clusters[m], seed=seed)
            tb = tds.cluster_batch(clusters[m], seed=seed)
            for k in rb:
                assert rb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(tb[k], rb[k])
                gathered = dsd.data[k].index_select(
                    0, torch.from_numpy(want[m, l].reshape(-1))).reshape(
                        tb[k].shape)
                np.testing.assert_array_equal(gathered.numpy(), tb[k])


def test_synthetic_data_bit_equal(ref):
    for a, b in zip(ref.synthetic.synthetic_mnist(50, 20, seed=1),
                    tsynth(50, 20, seed=1)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ytr = tsynth(300, 10, seed=1)[1]
    for a, b in zip(ref.synthetic.non_iid_split(ytr, 5, 3, 30, seed=2),
                    tnon_iid(ytr, 5, 3, 30, seed=2)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------

def test_trainer_two_rounds_match_reference(ref, data, tmp_path):
    rt, tt = _trainers(ref, data, tmp_path)
    rs = rt.run(jax.random.PRNGKey(0))
    ts = tt.run(state=cpsl_state_from_numpy(
        jax.device_get(rt.cpsl.init_state(jax.random.PRNGKey(0))), "cpu"))
    assert len(tt.history) == len(rt.history) == 2
    for a, b in zip(rt.history, tt.history):
        assert b["sim_latency_s"] == a["sim_latency_s"]
        assert b["sim_time_s"] == a["sim_time_s"]
        assert b["loss"] == pytest.approx(a["loss"], rel=LOSS_RTOL)
    assert int(ts["step"]) == int(rs["step"]) == 4
    for a, b in zip(jax.tree.leaves(jax.device_get(rs)), tree.leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)


def test_trainer_fused_round_equals_looped(ref, data, tmp_path):
    """In the port, ``fused_round`` reproduces the looped trainer bit for
    bit, with straggler keep tables drawn per round."""
    states = []
    for fused in (False, True):
        _, tt = _trainers(ref, data, tmp_path / str(fused), port_ccfg=dict(
            fused_round=fused, straggler_dropout=0.3))
        assert (tt._ds_dev is not None) == fused
        states.append((tt.run(torch.Generator().manual_seed(0)),
                       [h["loss"] for h in tt.history]))
    (sa, la), (sb, lb) = states
    assert la == lb
    for a, b in zip(tree.leaves(sa), tree.leaves(sb)):
        assert torch.equal(a, b)


def test_failure_then_resume_bit_exact(ref, data, tmp_path):
    _, full = _trainers(ref, data, tmp_path / "full", rounds=4)
    s_full = full.run(torch.Generator().manual_seed(0))
    _, crash = _trainers(ref, data, tmp_path / "crash", rounds=4,
                         fail_at_round=2)
    with pytest.raises(ttrainer.SimulatedFailure):
        crash.run(torch.Generator().manual_seed(0))
    assert crash.ckpt.steps() == [1, 2]
    _, resume = _trainers(ref, data, tmp_path / "crash", rounds=4)
    s_res = resume.run(torch.Generator().manual_seed(0))
    assert [h["round"] for h in resume.history] == [2, 3]
    assert [h["loss"] for h in resume.history] == \
        [h["loss"] for h in full.history[2:]]
    assert resume.history[-1]["sim_time_s"] == pytest.approx(
        full.history[-1]["sim_time_s"], rel=1e-6)
    for a, b in zip(tree.leaves(s_full), tree.leaves(s_res)):
        assert torch.equal(a, b)


def test_stop_checkpoints_at_the_round_boundary(ref, data, tmp_path):
    """A SIGTERM-style stop finishes the round, checkpoints it and exits;
    a new trainer resumes from there."""
    _, tt = _trainers(ref, data, tmp_path, rounds=3, ckpt_every=3)
    tt.stop.trigger()
    tt.run(torch.Generator().manual_seed(0))
    assert [h["round"] for h in tt.history] == [0]
    assert tt.ckpt.steps() == [1]
    _, again = _trainers(ref, data, tmp_path, rounds=3, ckpt_every=3)
    again.run(torch.Generator().manual_seed(0))
    assert [h["round"] for h in again.history] == [1, 2]


def test_gibbs_mc_raises(ref, data, tmp_path):
    """``"gibbs-mc"`` no longer raises: it plans like the reference's
    best-of-R lockstep chains; an unknown planner still raises."""
    rt, tt = _trainers(ref, data, tmp_path, resource_mgmt="gibbs-mc",
                       gibbs_chains=3)
    for rnd in range(2):
        rc, rx, rl = rt._plan_round(3, rnd)
        tc, tx, tl = tt._plan_round(3, rnd)
        assert [list(map(int, c)) for c in rc] == \
            [list(map(int, c)) for c in tc]
        for a, b in zip(rx, tx):
            np.testing.assert_array_equal(a, b)
        assert tl == rl
    _, bad = _trainers(ref, data, tmp_path / "bad", resource_mgmt="annealing")
    with pytest.raises(ValueError, match="annealing"):
        bad._plan_round(3, 0)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _meta(ref, optimizer="momentum"):
    rc = ref.cpsl.CPSL(ref.splitting.make_split_model("lenet", 3),
                       ref.configs.CPSLConfig(**CCFG, optimizer=optimizer,
                                              compress_uploads="topk"))
    rs = rc.init_state(jax.random.PRNGKey(1))
    rmeta = {"round": jnp.asarray(3, jnp.int32),
             "sim_time": jnp.asarray(12.5), "state": rs}
    tmeta = {"round": torch.tensor(3, dtype=torch.int32),
             "sim_time": torch.tensor(12.5),
             "state": cpsl_state_from_numpy(jax.device_get(rs), "cpu")}
    return rmeta, tmeta


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adamw"])
def test_payload_bytes_equal_reference(ref, optimizer):
    """The uncompressed msgpack payload is byte-for-byte the reference's
    (whichever codec the reference compressed it with)."""
    rmeta, tmeta = _meta(ref, optimizer)
    want = ref.checkpointer._decompress(ref.checkpointer.serialize(rmeta))
    assert tck.payload_bytes(tmeta) == want
    assert tck.serialize(tmeta) == zlib.compress(want, 6)


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_checkpoint_restores_across_packages(ref, tmp_path, direction):
    rmeta, tmeta = _meta(ref)
    zeros_r = jax.tree.map(jnp.zeros_like, rmeta)
    zeros_t = tree.map(torch.zeros_like, tmeta)
    if direction == "reference-to-port":
        ref.checkpointer.Checkpointer(str(tmp_path)).save(rmeta, step=3)
        got = tck.Checkpointer(str(tmp_path)).restore(zeros_t)
        for a, b in zip(jax.tree.leaves(rmeta), tree.leaves(got)):
            assert str(b.dtype).endswith(str(np.asarray(a).dtype))
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    else:
        tck.Checkpointer(str(tmp_path)).save(tmeta, step=3)
        got = ref.checkpointer.Checkpointer(str(tmp_path)).restore(zeros_r)
        for a, b in zip(tree.leaves(tmeta), jax.tree.leaves(got)):
            assert b.dtype == np.asarray(a.numpy()).dtype
            np.testing.assert_array_equal(np.asarray(b), a.numpy())


def test_corrupt_latest_falls_back_and_keep_k(tmp_path):
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save({"x": torch.full((2,), float(s))}, step=s)
    assert ck.steps() == [2, 3]
    path = tmp_path / "ckpt_0000000003"
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.warns(RuntimeWarning, match="checksum"):
        out = ck.restore({"x": torch.zeros(2)})
    assert float(out["x"][0]) == 2.0 and ck.restored_step == 2
    with pytest.raises(tck.CheckpointCorrupt):
        ck.restore({"x": torch.zeros(2)}, step=3)
    with pytest.raises(KeyError):
        ck.restore({"x": torch.zeros(2), "y": torch.zeros(1)}, step=2)


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
    b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"dtype": "float32", "shape": [2, 3], "data": b"\0" * 24},
], ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__")
                                          else o))
def test_msgpack_subset_matches_msgpack(obj):
    raw = tck.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert tck.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_msgpack_subset_refuses_other_types():
    with pytest.raises(TypeError):
        tck.packb(1.5)
    with pytest.raises(ValueError, match="not in the checkpoint format"):
        tck.unpackb(msgpack.packb(1.5))


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------

def test_launcher_runs_on_cpu_and_refuses_without_cuda(tmp_path,
                                                       monkeypatch):
    args = ["--model", "lenet", "--rounds", "2", "--clusters", "2",
            "--cluster-size", "2", "--cut", "3", "--n-train", "2000",
            "--n-test", "40", "--ckpt-dir", str(tmp_path / "c")]
    hist = tlaunch.main(args + ["--device", "cpu"])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0 <= h["eval"] <= 1 for h in hist)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(args)
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        tlaunch.main(args + ["--device", "cpu", "--arch", "whisper-small"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.DeviceResidentDataset(np.zeros((2, 28, 28, 1), np.float32),
                                    np.zeros(2, np.int32), [[0, 1]], 1)
