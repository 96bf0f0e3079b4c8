"""Port parity for the Mamba-2 serving slice: the SSD cores, the conv, the
Mamba block, its decode step, the stack's prefill and cache, and
``ServeEngine.generate`` against the JAX reference on the CPU.

The model is a reduced mamba2-2.7b (``reduce_for_smoke``: d 64, 2 layers,
N 16, P 16, chunk 8) in float32, with S = 24 so that three chunks carry
state. Parameters come from the reference's ``init`` and reach the port
through ``params_from_numpy``; activations are made with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import mamba2 as jmb
from repro.models import transformer as jtfm
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import streams, telemetry
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import api
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import ServeEngine

TOL = 1e-5
S = 24


def _cfgs(dtype="float32", impl="pallas"):
    kw = dict(dtype=dtype, ssd_impl=impl)
    jcfg = jregistry.reduce_for_smoke(jregistry.get("mamba2-2.7b"))
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b"))
    return jcfg.replace(**kw), cfg.replace(**kw)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _jlayer(params, n=0):
    return jax.tree.map(lambda t: t[n], params["stack"][0])


def _tlayer(params, n=0):
    return tfm._index(params["stack"][0], n)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _err(t, j):
    return float(np.abs(t.float().numpy()
                        - np.asarray(j, dtype=np.float32)).max())


def _ssd_inputs(seed, B_, S_, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, S_, H)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B_, S_, H, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B_, S_, H, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


# -- modules -----------------------------------------------------------------

def test_params_from_numpy_carries_stacked_mamba_params(model):
    jcfg, cfg, jparams, params = model
    jp, tp = jparams["stack"][0]["mamba"], params["stack"][0]["mamba"]
    assert sorted(tp) == sorted(jp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32 and t.shape[0] == cfg.n_periods
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    d_inner, H, conv_dim = mb.mamba_dims(cfg)
    assert tp["in_proj"]["w"].shape == (cfg.n_periods, cfg.d_model,
                                        2 * d_inner + 2 * 16 + H)
    assert tp["conv_w"].shape == (cfg.n_periods, cfg.ssm.d_conv, conv_dim)


def test_causal_conv_and_step(model):
    _, cfg, jparams, params = model
    jp, tp = _jlayer(jparams)["mamba"], _tlayer(params)["mamba"]
    _, _, conv_dim = mb.mamba_dims(cfg)
    x = _x(1, (2, S, conv_dim))
    want = jmb.causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    got = mb.causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    assert _err(got, want) < TOL
    state = _x(2, (2, cfg.ssm.d_conv - 1, conv_dim))
    x1 = _x(3, (2, conv_dim))
    jy, jstate = jmb.causal_conv_step(jnp.asarray(state), jnp.asarray(x1),
                                      jp["conv_w"], jp["conv_b"])
    ty, tstate = mb.causal_conv_step(torch.from_numpy(state),
                                     torch.from_numpy(x1), tp["conv_w"],
                                     tp["conv_b"])
    assert _err(ty, jy) < TOL and _err(tstate, jstate) < TOL


@pytest.mark.parametrize("impl,with_h0", [("scan", False), ("scan", True),
                                          ("chunked", False),
                                          ("chunked", True),
                                          ("pallas", False)])
def test_ssd_cores(impl, with_h0):
    arrays = _ssd_inputs(4, 2, S, 3, 16, 16)
    h0 = _x(15, (2, 3, 16, 16)) if with_h0 else None
    want = jmb.ssd(*(jnp.asarray(a) for a in arrays), impl=impl, chunk=8,
                   h0=None if h0 is None else jnp.asarray(h0))
    got = mb.ssd(*(torch.from_numpy(a) for a in arrays), impl=impl, chunk=8,
                 h0=None if h0 is None else torch.from_numpy(h0))
    assert _err(got[0], want[0]) < TOL and _err(got[1], want[1]) < TOL


def test_ssd_decode_step():
    x, dt, A, Bm, Cm = _ssd_inputs(5, 2, 1, 3, 16, 16)
    h = _x(6, (2, 3, 16, 16))
    args = (h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    jy, jh = jmb.ssd_decode_step(*(jnp.asarray(a) for a in args))
    ty, th = mb.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    assert _err(ty, jy) < TOL and _err(th, jh) < TOL


@pytest.mark.parametrize("impl", ["scan", "chunked", "pallas"])
def test_mamba_apply_with_state_and_decode_step(model, impl):
    jcfg, cfg, jparams, params = model
    jcfg, cfg = jcfg.replace(ssd_impl=impl), cfg.replace(ssd_impl=impl)
    jp, tp = _jlayer(jparams)["mamba"], _tlayer(params)["mamba"]
    x = _x(7, (2, S, cfg.d_model))
    jout, (jconv, jh) = jmb.mamba_apply(jp, jnp.asarray(x), jcfg,
                                        return_state=True)
    out, (conv, h) = mb.mamba_apply(tp, torch.from_numpy(x), cfg,
                                    return_state=True)
    assert _err(out, jout) < TOL
    assert conv.shape == (2, cfg.ssm.d_conv - 1, mb.mamba_dims(cfg)[2])
    assert _err(conv, jconv) < TOL and _err(h, jh) < TOL
    assert _err(mb.mamba_apply(tp, torch.from_numpy(x), cfg), jout) < TOL

    cache = {"conv": conv.clone(), "ssm": h.clone()}
    x1 = _x(8, (2, 1, cfg.d_model))
    jy, jcache = jmb.mamba_decode_step(jp, jnp.asarray(x1),
                                       {"conv": jconv, "ssm": jh}, jcfg)
    ty, tcache = mb.mamba_decode_step(tp, torch.from_numpy(x1), cache, cfg)
    assert tcache is cache               # updated in place
    assert _err(ty, jy) < TOL
    for name in ("conv", "ssm"):
        assert _err(cache[name], jcache[name]) < TOL


def test_block_prefill_and_decode(model):
    jcfg, cfg, jparams, params = model
    spec, jspec = cfg.pattern[0], jcfg.pattern[0]
    x = _x(9, (2, S, cfg.d_model))
    jx, _, jcache = jtfm.block_prefill(_jlayer(jparams), jnp.asarray(x),
                                       jcfg, jspec, jnp.arange(S), S + 2)
    tx, _, cache = tfm.block_prefill(_tlayer(params), torch.from_numpy(x),
                                     cfg, spec, torch.arange(S), S + 2)
    assert _err(tx, jx) < TOL
    for name in ("conv", "ssm"):
        assert _err(cache[name], jcache[name]) < TOL
    for pos, seed in ((S, 10), (S + 1, 11)):
        x1 = _x(seed, (2, 1, cfg.d_model))
        jx1, jcache = jtfm.block_decode(_jlayer(jparams), jnp.asarray(x1),
                                        jcache, jcfg, jspec, pos)
        tx1, cache = tfm.block_decode(_tlayer(params), torch.from_numpy(x1),
                                      cache, cfg, spec, pos)
        assert _err(tx1, jx1) < TOL
        for name in ("conv", "ssm"):
            assert _err(cache[name], jcache[name]) < TOL


# -- the slice as a whole ------------------------------------------------------

def test_prefill_logits_and_whole_cache(model):
    jcfg, cfg, jparams, params = model
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, S))
    jlogits, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   jcfg, cap=S + 4)
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                cfg, cap=S + 4)
    assert logits.shape == (2, cfg.vocab_size)
    assert _err(logits, jlogits) < 1e-4
    assert cache["prologue"] == [] and len(cache["stack"]) == 1
    for name in ("conv", "ssm"):
        got, want = cache["stack"][0][name], jcache["stack"][0][name]
        assert got.shape == want.shape == (
            (cfg.n_periods, 2) + tuple(want.shape[2:]))
        assert _err(got, want) < TOL
    full, _ = api.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _err(logits, full[:, -1].numpy()) < 1e-6


@pytest.mark.parametrize("impl", ["scan", "chunked", "pallas"])
def test_generate_matches_reference_f32(model, impl):
    jcfg, cfg, jparams, params = model
    jcfg, cfg = jcfg.replace(ssd_impl=impl), cfg.replace(ssd_impl=impl)
    steps = 8
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S))
    jeng = JServeEngine(jcfg, jparams, cap=S + steps)
    eng = ServeEngine(cfg, params, cap=S + steps, device="cpu")
    jlogits, _ = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 1e-4
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)},
                                    steps=steps))
    with telemetry.LaunchCounter() as launched:
        got = eng.generate({"tokens": torch.from_numpy(toks)}, steps=steps)
    assert launched["ssd"] == 0       # CPU tensors take the plain version
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_reference_bf16():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = japi.init(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, S))
    jlogits, _ = JServeEngine(jcfg, jparams, cap=S + 4).prefill(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    eng = ServeEngine(cfg, params, cap=S + 4, device="cpu")
    logits, _ = eng.prefill({"tokens": torch.from_numpy(toks)})
    assert _err(logits, jlogits) < 0.15    # tests/test_kernels.py bf16 path
    out = eng.generate({"tokens": torch.from_numpy(toks)}, steps=4)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_prompt_shorter_than_conv_window_raises(model):
    _, cfg, _, params = model
    eng = ServeEngine(cfg, params, cap=8, device="cpu")
    with pytest.raises(ValueError, match="shorter than"):
        eng.generate({"tokens": torch.zeros((2, 2), dtype=torch.int64)},
                     steps=2)


def test_port_init_is_seeded_and_serves():
    _, cfg = _cfgs()
    p1 = api.init(streams.model_generator(0, "cpu"), cfg)
    p2 = api.init(streams.model_generator(0, "cpu"), cfg)
    m1, m2 = p1["stack"][0]["mamba"], p2["stack"][0]["mamba"]
    assert torch.equal(m1["in_proj"]["w"], m2["in_proj"]["w"])
    assert torch.equal(m1["dt_bias"], m2["dt_bias"])
    A = -torch.exp(m1["A_log"])
    assert bool(((A <= -1.0) & (A >= -16.0)).all())
    toks = torch.randint(0, cfg.vocab_size, (2, S),
                         generator=streams.sampler_generator(1, "cpu"))
    out = ServeEngine(cfg, p1, cap=S + 3, device="cpu").generate(
        {"tokens": toks}, steps=3)
    assert out.shape == (2, 3)
