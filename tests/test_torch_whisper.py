"""Port parity for whisper (the encoder-decoder family): positions,
blocks, ``forward``, ``loss_fn`` and its gradients, prefill and decode,
``ServeEngine.generate`` and the serve launcher, against the JAX reference
on the CPU.

The model is a reduced whisper-small (``reduce_for_smoke``: 2 + 2
layers, enc_seq 24) in float32; the flash-attention cases use head dim 64
and enc_seq 100, so the encoder's non-causal attention and the decoder's
cross-attention (Sq != Skv) are ragged against the card kernel's 64-row
tiles. Parameters come from the reference's ``init`` and reach the port
through ``params_from_numpy``; frames and tokens are numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.flash_attention.kernel import \
    flash_attention_flat as jflash_flat
from repro.models import api as japi
from repro.models import whisper as jwhp
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import streams, telemetry, tree
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import whisper as whp
from repro_torch.serving.engine import ServeEngine

TOL = 1e-5
GRAD_TOL = 1e-5      # per leaf, err / max(1, max|leaf|), as in lm_split
DECODE_TOL = 1e-4    # prefill + decode against the reference and forward
F32_TOL, BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py: kernel vs oracle
S = 12


def _cfgs(dtype="float32", impl="pallas", jimpl="chunked", **kw):
    """(reference cfg, port cfg): reduced whisper-small; the port on
    ``impl`` (its kernel path by default), the reference on ``jimpl``."""
    jcfg = jregistry.reduce_for_smoke(jregistry.get("whisper-small"))
    cfg = registry.reduce_for_smoke(registry.get("whisper-small"))
    return (jcfg.replace(dtype=dtype, attn_impl=jimpl, **kw),
            cfg.replace(dtype=dtype, attn_impl=impl, **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(cfg, B=2, seq=S, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, seq), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, seq), np.int32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _err(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j, dtype=np.float32)).max())


def _leaf_errs(tleaves, jleaves):
    tl, jl = list(tleaves), list(jleaves)
    assert len(tl) == len(jl)
    out = []
    for t, j in zip(tl, jl):
        t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
        assert t.shape == j.shape, (t.shape, j.shape)
        out.append(float(np.abs(t - j).max())
                   / max(1.0, float(np.abs(j).max())))
    return out


def _jlayer(params, name, n=0):
    return jax.tree.map(lambda t: t[n], params[name])


def _tlayer(params, name, n=0):
    return tree.map(lambda t: t[n], params[name])


# -- positions -------------------------------------------------------------

# XLA's f32 exp and torch's are not both correctly rounded: of the 384
# frequencies exp(-ln(1e4) * i / (d/2 - 1)) at d = 768, 41 of XLA's and 10
# of torch's differ from the rounded exact value, by one ulp. Position p
# multiplies that into p * 1.2e-7 of the angle (1.8e-4 at p = 1500), so
# the tables agree to 1e-6 at equal frequencies, and otherwise to 1e-6
# plus two ulps of the angle.
FREQ_RTOL = 2.4e-7   # two f32 ulps


def _pos_tol(S_):
    return 1e-6 + FREQ_RTOL * np.arange(S_, dtype=np.float64)[:, None]


@pytest.mark.parametrize("S_,d", [(24, 64), (1500, 768), (7, 6)])
def test_sinusoid_pos(S_, d, monkeypatch):
    want = np.asarray(jwhp.sinusoid_pos(S_, d))
    got = whp.sinusoid_pos(S_, d)
    assert got.dtype == torch.float32 and got.shape == (S_, d)
    assert (np.abs(got.numpy() - want) <= _pos_tol(S_)).all()
    dim = jnp.arange(d // 2, dtype=jnp.float32)
    jinv = np.array(jnp.exp(-np.log(10000.0) * dim / max(d // 2 - 1, 1)))
    inv = whp._inv_freq(d, "cpu")
    assert np.abs(inv.numpy() / jinv - 1).max() <= FREQ_RTOL
    # at the reference's frequencies the tables agree to 1e-6
    monkeypatch.setattr(whp, "_inv_freq",
                        lambda d_, device: torch.from_numpy(jinv))
    assert _err(whp.sinusoid_pos(S_, d), want) < 1e-6


@pytest.mark.parametrize("pos", [0, 5, 447, 1499])
def test_sinusoid_pos_at(pos):
    want = np.asarray(jwhp.sinusoid_pos_at(jnp.asarray(pos), 768))
    got = whp.sinusoid_pos_at(pos, 768)
    assert got.shape == (768,)
    assert np.abs(got.numpy() - want).max() <= _pos_tol(pos + 1)[-1, 0]
    assert torch.equal(got, whp.sinusoid_pos(pos + 1, 768)[pos])


# -- blocks ------------------------------------------------------------------

def test_enc_block_apply(model):
    jcfg, cfg, jparams, params = model
    x = _x(1, (2, cfg.enc_seq, cfg.d_model))
    want = jwhp.enc_block_apply(_jlayer(jparams, "enc_stack", 1),
                                jnp.asarray(x), jcfg)
    got = whp.enc_block_apply(_tlayer(params, "enc_stack", 1),
                              torch.from_numpy(x), cfg)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("mode", ["memory", "mem_kv", "cached"])
def test_dec_block_apply(model, mode):
    """Cross-attention from ``memory`` or from given ``mem_kv``; and the
    decode form: one query over a self-attention cache (``self_kv``,
    ``kv_valid_len``)."""
    jcfg, cfg, jparams, params = model
    G, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    Sx = 1 if mode == "cached" else S
    x = _x(2, (2, Sx, cfg.d_model))
    mem = _x(3, (2, cfg.enc_seq, cfg.d_model))
    jp, tp = _jlayer(jparams, "dec_stack", 1), _tlayer(params, "dec_stack", 1)
    jkw, tkw = {}, {}
    if mode != "memory":
        mk, mv = _x(4, (2, cfg.enc_seq, G, hd)), _x(5, (2, cfg.enc_seq, G, hd))
        jkw["mem_kv"] = (jnp.asarray(mk), jnp.asarray(mv))
        tkw["mem_kv"] = (torch.from_numpy(mk), torch.from_numpy(mv))
    pos = np.arange(Sx) + (7 if mode == "cached" else 0)
    if mode == "cached":
        kc, vc = _x(6, (2, S, G, hd)), _x(7, (2, S, G, hd))
        jkw.update(self_kv=(jnp.asarray(kc), jnp.asarray(vc)),
                   kv_valid_len=8)
        tkw.update(self_kv=(torch.from_numpy(kc), torch.from_numpy(vc)),
                   kv_valid_len=8)
    want = jwhp.dec_block_apply(jp, jnp.asarray(x), jnp.asarray(mem), jcfg,
                                jnp.asarray(pos), **jkw)
    got = whp.dec_block_apply(tp, torch.from_numpy(x), torch.from_numpy(mem),
                              cfg, torch.from_numpy(pos), **tkw)
    assert _err(got, want) < TOL


# -- the model ---------------------------------------------------------------

def test_forward_and_loss_match_reference(model):
    jcfg, cfg, jparams, params = model
    b = _batch(cfg, seed=1)
    want, jaux = japi.forward(jparams, _jb(b), jcfg)
    got, aux = api.forward(params, _tb(b), cfg)
    assert got.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    assert _err(got, want) < TOL
    loss_j = japi.loss_fn(jparams, _jb(b), jcfg)
    loss = api.loss_fn(params, _tb(b), cfg)
    assert abs(float(loss) - float(loss_j)) < TOL


@pytest.mark.parametrize("start,end", [(0, 1), (1, 2), (0, 2)])
def test_encode_ranges_match_reference(model, start, end):
    """``start_layer``/``end_layer``: positions only at layer 0, the
    final norm only at the last layer."""
    jcfg, cfg, jparams, params = model
    fr = _x(8, (2, cfg.enc_seq, cfg.d_model))
    want = jwhp.encode(jparams, jnp.asarray(fr), jcfg, start, end)
    got = whp.encode(params, torch.from_numpy(fr), cfg, start, end)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_grads_match_reference(model, remat):
    """``loss_fn``'s gradients in every leaf against ``jax.grad``, with the
    encoder's and decoder's blocks checkpointed or not; the port's loss
    runs K1's ``autograd.Function`` (its plain version on the CPU)."""
    jcfg, cfg, jparams, params = model
    b = _batch(cfg, seed=2)
    loss_j, g_j = jax.value_and_grad(
        lambda p: japi.loss_fn(p, _jb(b), jcfg.replace(remat=remat)))(
        jparams)
    p = tree.map(lambda t: t.detach().requires_grad_(), params)
    loss = api.loss_fn(p, _tb(b), cfg.replace(remat=remat))
    g = torch.autograd.grad(loss, tree.leaves(p))
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    assert max(_leaf_errs(g, jax.tree.leaves(g_j))) <= GRAD_TOL
    assert all(bool(t.abs().max() > 0) for t in g)


def test_remat_recomputes_the_kernel_path(model):
    """K1's Function runs once per attention of a pass (12 + 2 * 12 at
    full size; here 2 + 2 * 2), and twice with remat: forward and the
    checkpoint's recompute."""
    _, cfg, _, params = model
    from repro_torch.kernels.flash_attention import ops as fa_ops
    n_attn = cfg.n_enc_layers + 2 * (cfg.n_layers - cfg.n_enc_layers)
    calls, orig = [], fa_ops._forward

    def counted(*a):
        calls.append(1)
        return orig(*a)

    fa_ops._forward = counted
    try:
        for remat, expect in ((False, n_attn), (True, 2 * n_attn)):
            calls.clear()
            p = tree.map(lambda t: t.detach().requires_grad_(), params)
            loss = api.loss_fn(p, _tb(_batch(cfg, seed=3)),
                               cfg.replace(remat=remat))
            torch.autograd.grad(loss, tree.leaves(p))
            assert len(calls) == expect, (remat, len(calls))
    finally:
        fa_ops._forward = orig


def test_prefill_and_decode_match_reference_and_forward(model):
    """Prefill on 8 tokens, then 4 decode steps: each step's logits
    against the reference's and against ``forward`` at that position
    (the reference's invariant, tests/test_archs.py)."""
    jcfg, cfg, jparams, params = model
    b = _batch(cfg, seed=4)
    full, _ = api.forward(params, _tb(b), cfg)
    pre = {"frames": b["frames"], "tokens": b["tokens"][:, :8]}
    jlast, jcache = japi.prefill(jparams, _jb(pre), jcfg, cap=S)
    last, cache = api.prefill(params, _tb(pre), cfg, cap=S)
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        k: tuple(t.shape) for k, t in jcache.items()}
    assert _err(last, jlast) < DECODE_TOL
    assert _err(last, full[:, 7].numpy()) < DECODE_TOL
    for i in range(8, S):
        tok = b["tokens"][:, i]
        jlast, jcache = japi.decode_step(jparams, jcache, jnp.asarray(tok),
                                         i, jcfg)
        last, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                      i, cfg)
        assert _err(last, jlast) < DECODE_TOL
        assert _err(last, full[:, i].numpy()) < DECODE_TOL
    for k in cache:
        assert _err(cache[k], jcache[k]) < DECODE_TOL
    with pytest.raises(IndexError, match="outside cache"):
        api.decode_step(params, cache, torch.from_numpy(tok), S, cfg)


def test_generate_matches_reference_f32(model):
    jcfg, cfg, jparams, params = model
    steps = 8
    b = _batch(cfg, seed=5)
    batch = {"frames": b["frames"], "tokens": b["tokens"]}
    jeng = JServeEngine(jcfg, jparams, cap=S + steps)
    eng = ServeEngine(cfg, params, cap=S + steps, device="cpu")
    jlogits, _ = jeng.prefill(_jb(batch))
    logits, _ = eng.prefill(_tb(batch))
    assert _err(logits, jlogits) < DECODE_TOL
    want = np.asarray(jeng.generate(_jb(batch), steps=steps))
    with telemetry.LaunchCounter() as launched:
        got = eng.generate(_tb(batch), steps=steps)
    assert launched["flash_attention"] == 0   # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (2, steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_reference_bf16():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jparams = japi.init(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    b = _batch(cfg, seed=6)
    batch = {"frames": b["frames"], "tokens": b["tokens"]}
    jlogits, _ = JServeEngine(jcfg, jparams, cap=S + 4).prefill(_jb(batch))
    eng = ServeEngine(cfg, params, cap=S + 4, device="cpu")
    logits, _ = eng.prefill(_tb(batch))
    assert _err(logits, jlogits) < 0.15    # tests/test_kernels.py bf16 path
    out = eng.generate(_tb(batch), steps=4)
    assert out.shape == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_full_config_param_count(monkeypatch):
    """whisper-small's init at full size, its weight matrices on the meta
    device: 0.24 B params within 2 %, as tests/test_archs.py holds the
    reference, and the reference's tree."""
    monkeypatch.setattr(cm, "_normal", lambda gen, shape, scale, dtype:
                        torch.empty(shape, dtype=dtype, device="meta"))
    cfg = registry.get("whisper-small")
    params = api.init(torch.Generator().manual_seed(0), cfg)
    n = sum(t.numel() for t in tree.leaves(params))
    assert abs(n - 0.24e9) / 0.24e9 < 0.02, n
    shapes = jax.eval_shape(lambda k: japi.init(k, jregistry.get(
        "whisper-small")), jax.random.PRNGKey(0))
    assert [tuple(s.shape) for s in jax.tree.leaves(shapes)] == [
        tuple(t.shape) for t in tree.leaves(params)]
    assert params["enc_stack"]["attn"]["wq"]["w"].shape == (12, 768, 768)


def test_port_init_is_seeded_and_serves():
    _, cfg = _cfgs()
    p1 = api.init(streams.model_generator(0, "cpu"), cfg)
    p2 = api.init(streams.model_generator(0, "cpu"), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p1),
                                                 tree.leaves(p2)))
    b = _batch(cfg, seed=7)
    out = ServeEngine(cfg, p1, cap=S + 3, device="cpu").generate(
        {"frames": torch.from_numpy(b["frames"]),
         "tokens": torch.from_numpy(b["tokens"])}, steps=3)
    assert out.shape == (2, 3)


# -- the flash-attention kernel's shapes: head dim 64, ragged tiles ---------

# (Sq, Skv, causal): the encoder's self-attention, the decoder's prompt
# and its cross-attention over the frames
FLAT_CASES = [(100, 100, False), (12, 12, True), (12, 100, False),
              (5, 100, False), (64, 300, False)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Sq,Skv,causal", FLAT_CASES)
def test_flash_plain_version_at_head_dim_64(Sq, Skv, causal, bf16):
    """The port's K1 wrapper on CPU tensors (its plain version) against
    the reference's Pallas kernel in interpret mode at D = 64, GQA R = 2,
    non-causal and Sq != Skv."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((4, Sq, 64), (2, Skv, 64), (2, Skv, 64)))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kw = dict(causal=causal, window=0, softcap=0.0, q_offset=0, kv_repeat=2)
    want = jflash_flat(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                       interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    with telemetry.LaunchCounter() as launched:
        got = fk.flash_attention_flat(tq, tk, tv, **kw)
    assert launched["flash_attention"] == 0
    assert got.dtype == tdt and _err(got, want) < (BF16_TOL if bf16
                                                   else F32_TOL)
    assert torch.equal(got, attention_ref(tq, tk, tv, **kw))


def test_pallas_path_matches_reference_pallas_at_head_dim_64():
    """The whole model with ``attn_impl="pallas"`` on both sides at head
    dim 64 and enc_seq 100: the port's K1 Function (plain version) against
    the reference's Pallas K1 in interpret mode, which halves its blocks
    until they divide; the port's kernel takes ragged tiles itself.
    Forward, loss gradients, and generate."""
    jcfg, cfg = _cfgs(jimpl="pallas", head_dim=64, enc_seq=100)
    jparams = japi.init(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    b = _batch(cfg, seed=8)
    want, _ = japi.forward(jparams, _jb(b), jcfg)
    got, _ = api.forward(params, _tb(b), cfg)
    assert _err(got, want) < TOL
    loss_j, g_j = jax.value_and_grad(
        lambda p: japi.loss_fn(p, _jb(b), jcfg))(jparams)
    p = tree.map(lambda t: t.detach().requires_grad_(), params)
    loss = api.loss_fn(p, _tb(b), cfg)
    g = torch.autograd.grad(loss, tree.leaves(p))
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    assert max(_leaf_errs(g, jax.tree.leaves(g_j))) <= GRAD_TOL
    batch = {"frames": b["frames"], "tokens": b["tokens"]}
    jout = JServeEngine(jcfg, jparams, cap=S + 4).generate(_jb(batch), 4)
    out = ServeEngine(cfg, params, cap=S + 4, device="cpu").generate(
        _tb(batch), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_cross_attention_stays_on_the_kernel_path(model):
    """With ``kv`` given and no causal or window mask ``gqa_apply`` keeps
    q_offset the int 0, so cross-attention reaches K1's Function (a
    tensor offset would send it to naive attention)."""
    _, cfg, _, params = model
    from repro_torch.kernels.flash_attention import ops as fa_ops
    seen, orig = [], fa_ops.flash_attention

    def spy(q, k, v, causal, window, softcap, q_offset):
        seen.append((q.shape[1], k.shape[1], causal, q_offset))
        return orig(q, k, v, causal, window, softcap, q_offset)

    fa_ops.flash_attention = spy
    try:
        api.forward(params, _tb(_batch(cfg, seed=10)), cfg)
    finally:
        fa_ops.flash_attention = orig
    n_enc, E = cfg.n_enc_layers, cfg.enc_seq
    assert seen == [(E, E, False, 0)] * n_enc + [
        (S, S, True, 0), (S, E, False, 0)] * (cfg.n_layers - n_enc)
    assert all(type(o) is int for *_, o in seen)


# -- the launcher ------------------------------------------------------------

def test_serve_launcher_serves_whisper(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "whisper-small", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6",
                       "--steps", "3"])
    out = capsys.readouterr().out
    assert "whisper-small: 2x3 tokens" in out and "first row" in out


def test_serve_launcher_refuses_without_cuda(monkeypatch):
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "whisper-small", "--reduced"])
