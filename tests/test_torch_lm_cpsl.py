"""Port parity for CPSL over split LMs: one round against the reference's
``run_round`` (fused and protocol steps), the flow of
``examples/cpsl_llm_training.py`` (SAA priced from the full qwen2-0.5b,
rounds over ``LMClusterData``, export), ``optim.adamw_mixed``, and the
launcher's ``--arch``, on the CPU.

Reduced configs in float32: the port with its kernel paths selected (the
``autograd.Function``s over the kernels' plain versions on the CPU), the
reference on its chunked jnp paths; states come from the reference's
``init_state`` through ``convert``, batches from numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import CPSLConfig as TCPSLConfig
from repro_torch.convert import cpsl_state_from_numpy, params_from_numpy
from repro_torch.core.channel import NetworkCfg
from repro_torch.core.cpsl import CPSL as TCPSL
from repro_torch.core.profile import lm_profile
from repro_torch.core.resource import saa_cut_selection
from repro_torch.core.splitting import make_split_model
from repro_torch.data.pipeline import LMClusterData
from repro_torch.data.synthetic import MarkovLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tfm
from repro_torch.streams import batch_seed

S = 24
ROUND_TOL = 1e-4     # per leaf, err / max(1, max|leaf|), after one round
                     # of 2 x 2 (measured: ~1e-7)
CURVE_RTOL = 1e-4    # per-round losses of the example's 6 rounds


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


def _cfgs(ref, arch, impl="pallas"):
    """(reference cfg, port cfg) in f32: the port on ``impl`` (its kernel
    paths by default), the reference on its chunked jnp paths (its Pallas
    kernels' forward math and custom_vjp backward)."""
    jcfg = ref.registry.reduce_for_smoke(ref.registry.get(arch)).replace(
        dtype="float32")
    cfg = registry.reduce_for_smoke(registry.get(arch)).replace(
        dtype="float32", attn_impl=impl, ssd_impl=impl)
    if arch == "gemma2-2b":         # a window that masks at S tokens
        jcfg = jcfg.replace(pattern=(dataclasses.replace(
            jcfg.pattern[0], window=8), jcfg.pattern[1]))
        cfg = cfg.replace(pattern=(dataclasses.replace(
            cfg.pattern[0], window=8), cfg.pattern[1]))
    return jcfg, cfg


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _max_leaf_err(tstate, jstate) -> float:
    tl, jl = tree.leaves(tstate), jax.tree.leaves(jstate)
    assert len(tl) == len(jl)
    errs = [0.0]
    for t, j in zip(tl, jl):
        t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
        assert t.shape == j.shape
        if t.size:
            errs.append(float(np.abs(t - j).max())
                        / max(1.0, float(np.abs(j).max())))
    return max(errs)


def _pair(ref, jcfg, cfg, v, **kw):
    rc = ref.cpsl.CPSL(ref.splitting.make_split_model(jcfg, v),
                       ref.configs.CPSLConfig(cut_layer=v, **kw))
    tc = TCPSL(make_split_model(cfg, v), TCPSLConfig(cut_layer=v, **kw))
    rs = rc.init_state(jax.random.PRNGKey(0))
    return rc, tc, rs, cpsl_state_from_numpy(jax.device_get(rs), "cpu")


@pytest.mark.parametrize("arch,v", [("gemma2-2b", 1), ("mamba2-2.7b", 1)])
@pytest.mark.parametrize("fused", [True, False])
def test_cpsl_lm_round_matches_reference(ref, arch, v, fused):
    """2 clusters x 2 clients, 2 sequences each, one round of seeded
    ``LMClusterData`` batches; the fused step and the explicit protocol
    step (reference ``tests/test_cpsl.py``)."""
    jcfg, cfg = _cfgs(ref, arch)
    rc, tc, rs, ts = _pair(ref, jcfg, cfg, v, n_clusters=2, cluster_size=2,
                           local_epochs=1, batch_per_device=2,
                           lr_device=0.3, lr_server=0.3, fused_step=fused)
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=0), 4, 2, S)
    batches = {(m, 0): data.cluster_batch([2 * m, 2 * m + 1],
                                          seed=batch_seed(0, 0, m, 0))
               for m in range(2)}
    rs, rm = rc.run_round(rs, lambda m, l: _jb(batches[m, l]), n_clusters=2)
    ts, tm = tc.run_round(ts, lambda m, l: _tb(batches[m, l]), n_clusters=2)
    assert tm["loss"] == pytest.approx(rm["loss"], rel=1e-5)
    assert int(ts["step"]) == int(rs["step"]) == 2
    assert _max_leaf_err({"dev": ts["dev"], "srv": ts["srv"]},
                         {"dev": rs["dev"], "srv": rs["srv"]}) <= ROUND_TOL


def _whisper_batches(cfg, M, K, B, seed=0):
    """{frames, tokens, labels} with leading (K, B) per cluster: Markov
    tokens from ``LMClusterData``, frames from numpy."""
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=seed), M * K, B, S)
    rng = np.random.default_rng(seed)
    out = {}
    for m in range(M):
        b = data.cluster_batch(list(range(m * K, (m + 1) * K)),
                               seed=batch_seed(0, 0, m, 0))
        b["frames"] = rng.standard_normal(
            (K, B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out[m, 0] = b
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_cpsl_whisper_round_matches_reference(ref, fused):
    """Reduced whisper-small split at v = 1 (the cut inside the encoder),
    2 clusters x 2 clients, 2 clips each with remat on: one
    ``cluster_step`` and ``fedavg``, then a whole ``run_round`` from the
    start, against the reference (``tests/test_archs.py::
    test_cpsl_train_step_smoke`` drives its enc-dec batches the same
    way)."""
    jcfg, cfg = _cfgs(ref, "whisper-small")
    jcfg, cfg = jcfg.replace(remat=True), cfg.replace(remat=True)
    kw = dict(n_clusters=2, cluster_size=2, local_epochs=1,
              batch_per_device=2, lr_device=0.3, lr_server=0.3,
              fused_step=fused)
    rc, tc, rs0, ts0 = _pair(ref, jcfg, cfg, 1, **kw)
    assert tc.split.kind == "encdec"
    batches = _whisper_batches(cfg, 2, 2, 2)
    rs, rm = rc.cluster_step(rs0, _jb(batches[0, 0]))
    ts, tm = tc.cluster_step(ts0, _tb(batches[0, 0]))
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    rs, ts = rc.fedavg(rs), tc.fedavg(ts)
    assert _max_leaf_err({"dev": ts["dev"], "srv": ts["srv"]},
                         {"dev": rs["dev"], "srv": rs["srv"]}) <= ROUND_TOL
    for leaf in tree.leaves(ts["dev"]):
        assert torch.equal(leaf[0], leaf[1])

    rs, rm = rc.run_round(rs0, lambda m, l: _jb(batches[m, l]), n_clusters=2)
    ts, tm = tc.run_round(ts0, lambda m, l: _tb(batches[m, l]), n_clusters=2)
    assert tm["loss"] == pytest.approx(rm["loss"], rel=1e-5)
    assert int(ts["step"]) == int(rs["step"]) == 2
    assert _max_leaf_err({"dev": ts["dev"], "srv": ts["srv"]},
                         {"dev": rs["dev"], "srv": rs["srv"]}) <= ROUND_TOL
    params, out_cfg = tc.export_params(ts)
    jparams, _ = rc.export_params(rs)
    assert out_cfg == cfg
    assert _max_leaf_err(params, jparams) <= ROUND_TOL


@pytest.mark.parametrize("seq", [64, 448])
def test_lm_profile_whisper_matches_reference(ref, seq):
    """The enc-dec branch of ``lm_profile`` (cuts inside the encoder, the
    decoder priced on the server), and the SAA decision it gives over
    cuts 1..11 at a 2 x 2 layout."""
    prof = lm_profile(registry.get("whisper-small"), seq=seq)
    jprof = ref.profile.lm_profile(ref.registry.get("whisper-small"),
                                   seq=seq)
    assert len(prof.xi_d) == 12
    for f in ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB", "gamma_sF",
              "gamma_sB"):
        np.testing.assert_array_equal(getattr(prof, f), getattr(jprof, f))
    net = dict(n_devices=4, f_mean_range=(5e9, 50e9),
               snr_mean_range_db=(15, 35))
    saa = dict(B=4, L=1, n_clusters=2, cluster_size=2, n_samples=2,
               gibbs_iters=40, cuts=range(1, 12))
    v, means = saa_cut_selection(prof, NetworkCfg(**net), **saa)
    jv, jmeans = ref.resource.saa_cut_selection(
        jprof, ref.channel.NetworkCfg(**net), **saa)
    assert v == jv and 1 <= v < 12
    np.testing.assert_array_equal(means, jmeans)


def test_example_flow_matches_reference(ref):
    """``examples/cpsl_llm_training.py`` at its sizes (reduced qwen2-0.5b,
    seq 64, 4 sequences a client, 2 clusters of 3, 6 rounds), in float32
    so that the two packages can be compared: the same SAA decision from
    the full architecture's profile, the same per-round losses, and the
    same assembled model after ``export_params``."""
    seq, batch, M, K = 64, 4, 2, 3
    full = lm_profile(registry.get("qwen2-0.5b"), seq=4096)
    jfull = ref.profile.lm_profile(ref.registry.get("qwen2-0.5b"), seq=4096)
    for f in ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB", "gamma_sF",
              "gamma_sB"):
        np.testing.assert_array_equal(getattr(full, f), getattr(jfull, f))
    net = dict(n_devices=M * K, f_mean_range=(5e9, 50e9),
               snr_mean_range_db=(15, 35))
    saa = dict(B=batch, L=1, n_clusters=M, cluster_size=K, n_samples=2,
               gibbs_iters=40, cuts=range(1, 7))
    v_star, means = saa_cut_selection(full, NetworkCfg(**net), **saa)
    jv, jmeans = ref.resource.saa_cut_selection(
        jfull, ref.channel.NetworkCfg(**net), **saa)
    assert v_star == jv
    np.testing.assert_array_equal(means, jmeans)

    jcfg, cfg = _cfgs(ref, "qwen2-0.5b", impl="chunked")
    v = min(v_star, cfg.n_layers - 1)
    rc, tc, rs, ts = _pair(ref, jcfg, cfg, v, n_clusters=M, cluster_size=K,
                           lr_device=0.3, lr_server=0.3)
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=0), M * K, batch, seq)
    devices = list(range(M * K))
    losses, jlosses = [], []
    for _ in range(6):
        bs = [data.cluster_batch(devices[m * K:(m + 1) * K])
              for m in range(M)]
        rs, rm = rc.run_round(rs, lambda m, l: _jb(bs[m]), n_clusters=M)
        ts, tm = tc.run_round(ts, lambda m, l: _tb(bs[m]), n_clusters=M)
        losses.append(tm["loss"])
        jlosses.append(rm["loss"])
    np.testing.assert_allclose(losses, jlosses, rtol=CURVE_RTOL)
    assert losses[-1] < losses[0]

    params, out_cfg = tc.export_params(ts)
    jparams, jout_cfg = rc.export_params(rs)
    toks = np.zeros((1, 8), np.int32)
    with torch.no_grad():
        logits, _ = tfm.forward(params, torch.from_numpy(toks), out_cfg)
    jlogits, _ = jax.jit(lambda p, t: ref.transformer.forward(
        p, t, jout_cfg))(jparams, jnp.asarray(toks))
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert _max_leaf_err([logits], [jlogits]) <= ROUND_TOL


def test_adamw_mixed_matches_reference(ref):
    """bf16 params with an f32 master copy: three steps at a schedule's
    lrs, the third with an lr scale."""
    rng = np.random.default_rng(0)
    p32 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
           "b": [rng.standard_normal((3,)).astype(np.float32)]}
    grads = [{"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal((3,)).astype(np.float32)]}
             for _ in range(3)]
    sched = dict(peak=0.1, warmup=2, total=10)
    jo = ref.optim.make("adamw_mixed", ref.optim.cosine_schedule(**sched),
                        weight_decay=0.01)
    to = toptim.make("adamw_mixed", toptim.cosine_schedule(**sched),
                     weight_decay=0.01)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p32)
    tp = params_from_numpy(p32, "cpu", torch.bfloat16)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        scale = 0.5 if i == 2 else None
        jp, js = jo.step(jax.tree.map(jnp.asarray, g), js, jp, step=i,
                         lr_scale=scale)
        tp, ts = to.step(params_from_numpy(g, "cpu"), ts, tp, step=i,
                         lr_scale=scale)
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(tp))
    assert _max_leaf_err(ts, js) <= 1e-6
    for t, m in zip(tree.leaves(tp), tree.leaves(ts["master"])):
        assert torch.equal(t, m.to(torch.bfloat16))


def test_launcher_trains_an_lm_on_cpu_and_refuses_without_cuda(
        tmp_path, monkeypatch, capsys):
    """``--arch qwen2-0.5b --reduced`` through ``CPSLTrainer``: two rounds,
    a checkpoint, and a resumed third round; without ``--device cpu``
    (no CUDA) it raises."""
    args = ["--arch", "qwen2-0.5b", "--reduced", "--clusters", "2",
            "--cluster-size", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ck")]
    hist = tlaunch.main(args + ["--rounds", "2", "--device", "cpu"])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["sim_latency_s"] > 0
               for h in hist)
    assert "[SAA] optimal cut layer" in capsys.readouterr().out
    more = tlaunch.main(args + ["--rounds", "3", "--device", "cpu"])
    assert [h["round"] for h in more] == [2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(args + ["--rounds", "1"])
