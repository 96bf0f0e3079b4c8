"""Port parity for the serving slice: gemma2 modules, blocks and
``ServeEngine.generate`` against the JAX reference on the CPU, plus the
port's own contracts (no JAX import, no silent CPU fallback).

The model is a reduced gemma2-2b (``reduce_for_smoke``) in float32 with a
local window of 8 on the first layer of each period, so the window bites
at S = 16. Parameters come from the reference's ``init`` and reach the port
through ``params_from_numpy``; activations are made with numpy.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import transformer as jtfm
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import streams, telemetry
from repro_torch.configs import registry
from repro_torch.configs.base import LayerSpec
from repro_torch.convert import params_from_numpy
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
S = 16


def _cfgs(dtype="float32", impl="pallas"):
    kw = dict(dtype=dtype, attn_impl=impl)
    jcfg = jregistry.reduce_for_smoke(jregistry.get("gemma2-2b"))
    jcfg = jcfg.replace(pattern=(JLayerSpec("attn", "dense", window=8),
                                 jcfg.pattern[1]), **kw)
    cfg = registry.reduce_for_smoke(registry.get("gemma2-2b"))
    cfg = cfg.replace(pattern=(LayerSpec("attn", "dense", window=8),
                               cfg.pattern[1]), **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _layer(params, pos, n=0):
    """Period n's params of pattern position pos (either package)."""
    return jax.tree.map(lambda t: t[n], params["stack"][pos])


def _tlayer(params, pos, n=0):
    return tfm._index(params["stack"][pos], n)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(t, j):
    return float(np.abs(t.float().numpy()
                        - np.asarray(j, dtype=np.float32)).max())


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", jregistry.list_archs())
def test_registry_matches_reference(arch):
    assert registry.list_archs() == jregistry.list_archs()
    for reduce in (False, True):
        j, t = jregistry.get(arch), registry.get(arch)
        if reduce:
            j, t = jregistry.reduce_for_smoke(j), registry.reduce_for_smoke(t)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_periods == j.n_periods
        assert t.resolved_head_dim == j.resolved_head_dim


# -- modules -----------------------------------------------------------------

def test_apply_norm(model):
    jcfg, cfg, _, _ = model
    x = _x(0, (2, S, cfg.d_model))
    scale = _x(1, (cfg.d_model,))
    want = jcm.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                          jcfg.norm_kind, jcfg.norm_eps)
    got = cm.apply_norm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x), cfg.norm_kind, cfg.norm_eps)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope(model, offset):
    _, cfg, _, _ = model
    x = _x(2, (2, S, 4, cfg.resolved_head_dim))
    pos = np.arange(S) + offset
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    got = cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        cfg.rope_theta)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("pos", [0, 1])       # local (window 8), global
def test_gqa_apply(model, impl, pos):
    jcfg, cfg, jparams, params = model
    window = cfg.pattern[pos].window
    x = _x(3, (2, S, cfg.d_model))
    want = jcm.gqa_apply(_layer(jparams, pos)["attn"], jnp.asarray(x), jcfg,
                         causal=True, window=window, impl=impl)
    got = cm.gqa_apply(_tlayer(params, pos)["attn"], torch.from_numpy(x),
                       cfg, causal=True, window=window, impl=impl)
    assert _err(got, want) < TOL


def test_mlp_apply(model):
    jcfg, cfg, jparams, params = model
    x = _x(4, (2, S, cfg.d_model))
    want = jcm.mlp_apply(_layer(jparams, 0)["mlp"], jnp.asarray(x), jcfg)
    got = cm.mlp_apply(_tlayer(params, 0)["mlp"], torch.from_numpy(x), cfg)
    assert _err(got, want) < TOL


def test_embed_and_logits_apply(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S))
    want = jcm.embed_apply(jparams["embed"], jnp.asarray(toks), jcfg)
    got = cm.embed_apply(params["embed"], torch.from_numpy(toks), cfg)
    assert _err(got, want) < TOL
    x = 3.0 * _x(6, (2, 3, cfg.d_model))    # large enough for the softcap
    want = jcm.logits_apply(jparams["embed"], jnp.asarray(x), jcfg)
    got = cm.logits_apply(params["embed"], torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 3, cfg.vocab_size)
    assert float(got.abs().max()) < cfg.final_softcap
    assert _err(got, want) < TOL


@pytest.mark.parametrize("pos", [0, 1])
def test_block_prefill_and_decode(model, pos):
    jcfg, cfg, jparams, params = model
    spec, jspec = cfg.pattern[pos], jcfg.pattern[pos]
    cap = S + 2
    x = _x(7, (2, S, cfg.d_model))
    jx, _, jcache = jtfm.block_prefill(_layer(jparams, pos), jnp.asarray(x),
                                       jcfg, jspec, jnp.arange(S), cap)
    tx, _, cache = tfm.block_prefill(_tlayer(params, pos),
                                     torch.from_numpy(x), cfg, spec,
                                     torch.arange(S), cap)
    assert _err(tx, jx) < TOL
    for name in ("k", "v"):
        assert _err(cache[name], jcache[name]) < TOL

    x1 = _x(8, (2, 1, cfg.d_model))
    jx1, jcache = jtfm.block_decode(_layer(jparams, pos), jnp.asarray(x1),
                                    jcache, jcfg, jspec, S)
    tx1, cache = tfm.block_decode(_tlayer(params, pos), torch.from_numpy(x1),
                                  cache, cfg, spec, S)
    assert _err(tx1, jx1) < TOL
    for name in ("k", "v"):
        assert _err(cache[name], jcache[name]) < TOL


# -- the slice as a whole ------------------------------------------------------

def test_forward_matches_reference(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S))
    want, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = api.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    assert _err(got, want) < 1e-4
    last, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _err(last, got[:, -1].numpy()) < 1e-6


def test_generate_matches_reference_f32(model):
    jcfg, cfg, jparams, params = model
    steps = 8
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, S))
    jeng = JServeEngine(jcfg, jparams, cap=S + steps)
    eng = ServeEngine(cfg, params, cap=S + steps, device="cpu")
    jlogits, _ = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 1e-4
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)},
                                    steps=steps))
    with telemetry.LaunchCounter() as launched:
        got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=steps)
    assert launched["flash_attention"] == 0   # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_reference_bf16():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = japi.init(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, S))
    jlogits, _ = JServeEngine(jcfg, jparams, cap=S + 4).prefill(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    eng = ServeEngine(cfg, params, cap=S + 4, device="cpu")
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 0.15    # tests/test_kernels.py bf16 path
    out = eng.generate({"tokens": torch.from_numpy(toks)}, steps=4)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_generate_temperature_is_seeded(model):
    _, cfg, _, params = model
    eng = ServeEngine(cfg, params, cap=S + 4, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (2, S)))}
    runs = [eng.generate(batch, steps=4, temperature=0.8,
                         generator=streams.sampler_generator(2, "cpu"))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 4)


def test_port_init_is_seeded_and_serves():
    _, cfg = _cfgs()
    p1 = api.init(streams.model_generator(0, "cpu"), cfg)
    p2 = api.init(streams.model_generator(0, "cpu"), cfg)
    assert torch.equal(p1["stack"][1]["attn"]["wq"]["w"],
                       p2["stack"][1]["attn"]["wq"]["w"])
    assert p1["stack"][0]["attn"]["wq"]["w"].shape == (
        cfg.n_periods, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=streams.sampler_generator(1, "cpu"))
    out = ServeEngine(cfg, p1, cap=S + 3, device="cpu").generate(
        {"tokens": toks}, steps=3)
    assert out.shape == (2, 3)


# -- the MoE and MLA models ---------------------------------------------------
# Reduced deepseek-v2-lite (MLA, a dense prologue layer, MoE with shared
# experts), phi3.5-moe (GQA + MoE) and jamba (one attention layer and seven
# Mamba-2 layers a period, MoE at odd offsets), float32, the kernel paths
# selected on both sides (the reference's Pallas kernels in interpret mode,
# the port's wrappers on their plain versions).

MOE_ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
             "jamba-v0.1-52b"]


def _moe_cfgs(arch, dtype="float32"):
    kw = dict(dtype=dtype, attn_impl="pallas", ssd_impl="pallas")
    return (jregistry.reduce_for_smoke(jregistry.get(arch)).replace(**kw),
            registry.reduce_for_smoke(registry.get(arch)).replace(**kw))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    jcfg, cfg = _moe_cfgs(request.param)
    jparams = japi.init(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def test_moe_forward_matches_reference(moe_model):
    jcfg, cfg, jparams, params = moe_model
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, S))
    want, aux_j = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = api.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _err(got, want) < 1e-4
    assert float(aux) > 0 and abs(float(aux) - float(aux_j)) < 1e-6
    last, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _err(last, got[:, -1].numpy()) < 1e-5


def _blocks(jparams, params, where, pos):
    """One block's params in each package: the prologue's block ``pos`` or
    period 0's block at pattern position ``pos``."""
    if where == "prologue":
        return jparams["prologue"][pos], params["prologue"][pos]
    return _layer(jparams, pos), _tlayer(params, pos)


# (arch, where, pattern position): every distinct block kind
MOE_BLOCKS = [("deepseek-v2-lite-16b", "prologue", 0),   # MLA + dense
              ("deepseek-v2-lite-16b", "stack", 0),      # MLA + MoE
              ("phi3.5-moe-42b-a6.6b", "stack", 0),      # GQA + MoE
              ("jamba-v0.1-52b", "stack", 0),            # Mamba + dense
              ("jamba-v0.1-52b", "stack", 1),            # Mamba + MoE
              ("jamba-v0.1-52b", "stack", 4)]            # GQA + dense


@pytest.mark.parametrize("arch,where,pos", MOE_BLOCKS)
def test_moe_block_prefill_and_decode(arch, where, pos):
    """``block_prefill`` (the MLA latent written into the cache, the MoE's
    aux) and three ``block_decode`` steps (absorbed MLA, ``no_drop`` MoE)
    against the reference, cache and all."""
    jcfg, cfg = _moe_cfgs(arch)
    jparams = japi.init(jax.random.PRNGKey(4), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    specs = cfg.prologue if where == "prologue" else cfg.pattern
    spec, jspec = specs[pos], (jcfg.prologue if where == "prologue"
                               else jcfg.pattern)[pos]
    jp, tp = _blocks(jparams, params, where, pos)
    cap = S + 3
    x = _x(15, (2, S, cfg.d_model))
    jx, jaux, jcache = jtfm.block_prefill(jp, jnp.asarray(x), jcfg, jspec,
                                          jnp.arange(S), cap)
    tx, aux, cache = tfm.block_prefill(tp, torch.from_numpy(x), cfg, spec,
                                       torch.arange(S), cap)
    assert _err(tx, jx) < TOL
    assert abs(float(aux) - float(jaux)) < 1e-6
    assert (float(aux) > 0) == (spec.ffn == "moe")
    assert sorted(cache) == sorted(jcache)
    for name in jcache:
        assert _err(cache[name], jcache[name]) < TOL, name
    for step in range(3):
        x1 = _x(16 + step, (2, 1, cfg.d_model))
        jx1, jcache = jtfm.block_decode(jp, jnp.asarray(x1), jcache, jcfg,
                                        jspec, S + step)
        tx1, cache = tfm.block_decode(tp, torch.from_numpy(x1), cache, cfg,
                                      spec, S + step)
        assert _err(tx1, jx1) < TOL
        for name in jcache:
            assert _err(cache[name], jcache[name]) < TOL, name


def test_moe_block_prefill_drops_above_4096_tokens():
    """B*S > 4096: the MoE FFN takes the capacity-bounded route, as the
    reference's does (here with a capacity factor that drops choices),
    and the result is not the no-drop one."""
    jcfg, cfg = _moe_cfgs("deepseek-v2-lite-16b")
    kw = dict(attn_impl="naive")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=0.5), **kw)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5),
                      **kw)
    jparams = japi.init(jax.random.PRNGKey(5), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    spec, jspec = cfg.pattern[0], jcfg.pattern[0]
    Sl = 2049                                        # B*S = 4098
    x = _x(19, (2, Sl, cfg.d_model))
    jx, jaux, _ = jtfm.block_prefill(_layer(jparams, 0), jnp.asarray(x),
                                     jcfg, jspec, jnp.arange(Sl), Sl)
    tx, aux, _ = tfm.block_prefill(_tlayer(params, 0), torch.from_numpy(x),
                                   cfg, spec, torch.arange(Sl), Sl)
    assert _err(tx, jx) < TOL and abs(float(aux) - float(jaux)) < 1e-6
    # the same block below the threshold routes every choice
    below, _, _ = tfm.block_prefill(_tlayer(params, 0),
                                    torch.from_numpy(x[:, :2048]), cfg,
                                    spec, torch.arange(2048), 2048)
    assert float((below - tx[:, :2048]).abs().max()) > 1e-3


def test_moe_generate_matches_reference_f32(moe_model):
    jcfg, cfg, jparams, params = moe_model
    steps = 6
    toks = np.random.default_rng(20).integers(0, cfg.vocab_size, (2, S))
    jeng = JServeEngine(jcfg, jparams, cap=S + steps)
    eng = ServeEngine(cfg, params, cap=S + steps, device="cpu")
    jlogits, _ = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 1e-4
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)},
                                    steps=steps))
    got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=steps)
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_generate_matches_reference_bf16(arch):
    jcfg, cfg = _moe_cfgs(arch, dtype="bfloat16")
    jparams = japi.init(jax.random.PRNGKey(6), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, S))
    jlogits, _ = JServeEngine(jcfg, jparams, cap=S + 4).prefill(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    eng = ServeEngine(cfg, params, cap=S + 4, device="cpu")
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 0.15    # tests/test_kernels.py bf16 path
    out = eng.generate({"tokens": torch.from_numpy(toks)}, steps=4)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_serves_moe_archs(arch, capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--param-dtype", "bfloat16", "--batch", "2",
                       "--prompt-len", "12", "--steps", "3"])
    out = capsys.readouterr().out
    assert f"{arch}: 2x3 tokens" in out and "first row" in out


def test_params_from_numpy_bf16_leaves():
    a = np.asarray(jnp.asarray(_x(12, (3, 5))).astype(jnp.bfloat16))
    t = params_from_numpy({"w": [a]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    t32 = params_from_numpy((a,), "cpu", torch.float32)[0]
    assert t32.dtype == torch.float32 and torch.equal(t32, t.float())


# -- the port's own contracts -------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "torch_dynamics_sim.py",
        ROOT / "examples" / "torch_rt_loopback.py"]


def test_port_never_imports_jax_or_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.models.mamba2, "
            "repro_torch.models.whisper, repro_torch.core.splitting, "
            "repro_torch.kernels.ssd.ops, repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.core.cpsl, "
            "repro_torch.core.profile, repro_torch.checkpoint.checkpointer, "
            "repro_torch.convert, repro_torch.sim.batched, "
            "repro_torch.telemetry, repro_torch.sim.dynamics, "
            "repro_torch.sim.controller, repro_torch.sim.engine, "
            "repro_torch.sim.fleet, repro_torch.rt, repro_torch.rt.device, "
            "repro_torch.rt.crossval, repro_torch.codec, "
            "repro_torch.launch.mesh, repro_torch.launch.roofline, "
            "repro_torch.launch.hlo_analysis, repro_torch.launch.dryrun, "
            "repro_torch.core.partitioning, repro_torch.analysis, "
            "repro_torch.analysis.__main__, repro_torch.analysis.report, "
            "repro_torch.analysis.rng_lint, "
            "repro_torch.analysis.thread_lint, "
            "repro_torch.analysis.jit_audit, chip_smoke; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_engine_refuses_cpu_fallback(model, monkeypatch):
    _, cfg, _, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, cap=S)
    assert ServeEngine(cfg, params, cap=S, device="cpu").device.type == "cpu"
