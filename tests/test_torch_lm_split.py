"""Port parity for split-LM training: ``transformer.loss_fn`` with and
without remat and ``core.splitting.make_lm_split``, against the JAX
reference on the CPU (CPSL rounds over these splits are in
``test_torch_lm_cpsl.py``).

The models are reduced configs (``reduce_for_smoke``) in float32: the
port with its kernel paths selected (``attn_impl``/``ssd_impl =
"pallas"``: the ``autograd.Function``s over the kernels' plain versions on
the CPU), the reference on its chunked jnp paths. gemma2's local window is
cut to 8 positions so that it masks at the tests' 24 tokens, and it is cut
at an odd and an even layer (the server's stack then starts on a global
layer or on a local one). Parameters and CPSL states are drawn by the
reference and carried across with ``convert``; batches are numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.core.splitting import make_lm_split
from repro_torch.models import api
from repro_torch.models import transformer as tfm

S = 24
GRAD_TOL = 1e-5      # per leaf, err / max(1, max|leaf|); f32, sums in
                     # another order (measured: <= 3e-7)


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


def _short_window(cfg):
    if cfg.name != "gemma2-2b":
        return cfg
    return cfg.replace(pattern=(dataclasses.replace(cfg.pattern[0],
                                                    window=8),
                                cfg.pattern[1]))


def _cfgs(ref, arch):
    """(reference cfg, port cfg): the port on its kernel paths, the
    reference on the chunked jnp paths that are its Pallas kernels'
    forward math and their custom_vjp's backward (the Pallas kernels
    themselves meet the port's Functions in test_torch_lm_ops.py)."""
    jcfg = ref.registry.reduce_for_smoke(ref.registry.get(arch))
    cfg = registry.reduce_for_smoke(registry.get(arch))
    return (_short_window(jcfg.replace(dtype="float32")),
            _short_window(cfg.replace(dtype="float32", attn_impl="pallas",
                                      ssd_impl="pallas")))


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaf_errs(tleaves, jleaves):
    tl, jl = list(tleaves), list(jleaves)
    assert len(tl) == len(jl)
    out = []
    for t, j in zip(tl, jl):
        t = t.detach().float().numpy()
        j = np.asarray(j, np.float32)
        assert t.shape == j.shape, (t.shape, j.shape)
        if t.size:
            out.append(float(np.abs(t - j).max())
                       / max(1.0, float(np.abs(j).max())))
    return out


def _grads(loss, leaves):
    """Gradients of ``loss`` in ``leaves``; a leaf the loss does not read
    (a server stack of no whole period) gets zeros."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def _requires_grad(params):
    return tree.map(lambda t: t.detach().requires_grad_(), params)


# --------------------------------------------------------------------------
# transformer.loss_fn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-2.7b"])
def test_loss_fn_remat_variants_match_reference(ref, arch):
    """Remat off, on, and two-level (``remat_group`` = 2): the same value
    to the bit and the same gradients, held against the reference's."""
    jcfg, cfg = _cfgs(ref, arch)
    jparams = ref.transformer.init(jax.random.PRNGKey(0), jcfg)
    b = _batch(cfg, 2)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, b_: ref.transformer.loss_fn(p, b_, jcfg)))(jparams, _jb(b))
    base = params_from_numpy(jax.device_get(jparams), "cpu")
    losses, grads = [], []
    for kw in (dict(remat=False), dict(remat=True),
               dict(remat=True, remat_group=2)):
        params = _requires_grad(base)
        loss = api.loss_fn(params, _tb(b), cfg.replace(**kw))
        losses.append(float(loss.detach()))
        grads.append(_grads(loss, tree.leaves(params)))
    assert losses[0] == losses[1] == losses[2]
    assert losses[0] == pytest.approx(float(loss_j), rel=1e-6)
    for g in grads:
        assert max(_leaf_errs(g, jax.tree.leaves(g_j))) <= GRAD_TOL
        for a, b_ in zip(g, grads[0]):
            assert torch.equal(a, b_)


def test_remat_recomputes_the_kernel_path():
    """With remat each attention layer's Function runs again in backward
    (forward + recompute), which is what the card's launch count
    formula counts: two forwards of every layer per step."""
    cfg = _short_window(registry.reduce_for_smoke(registry.get("gemma2-2b"))
                        ).replace(dtype="float32", attn_impl="pallas")
    params = _requires_grad(api.init(torch.Generator().manual_seed(0), cfg))
    calls = []
    from repro_torch.kernels.flash_attention import ops as fa_ops
    orig = fa_ops._forward

    def counted(*a):
        calls.append(1)
        return orig(*a)

    fa_ops._forward = counted
    try:
        for remat, expect in ((False, cfg.n_layers),
                              (True, 2 * cfg.n_layers)):
            calls.clear()
            loss = api.loss_fn(params, _tb(_batch(cfg, 2)),
                               cfg.replace(remat=remat))
            _grads(loss, tree.leaves(params))
            assert len(calls) == expect, (remat, len(calls))
    finally:
        fa_ops._forward = orig


# --------------------------------------------------------------------------
# make_lm_split
# --------------------------------------------------------------------------

SPLITS = [("gemma2-2b", 1), ("gemma2-2b", 2), ("gemma2-2b", 3),
          ("mamba2-2.7b", 1), ("qwen2-0.5b", 1)]


def _split_pair(ref, arch, v):
    jcfg, cfg = _cfgs(ref, arch)
    js, ts = ref.splitting.make_lm_split(jcfg, v), make_lm_split(cfg, v)
    jdev = js.init_device(jax.random.PRNGKey(1))
    jsrv = js.init_server(jax.random.PRNGKey(2))
    tdev = params_from_numpy(jax.device_get(jdev), "cpu")
    tsrv = params_from_numpy(jax.device_get(jsrv), "cpu")
    return js, ts, jdev, jsrv, tdev, tsrv, cfg


@pytest.mark.parametrize("arch,v", SPLITS)
def test_lm_split_matches_reference(ref, arch, v):
    js, ts, jdev, jsrv, tdev, tsrv, cfg = _split_pair(ref, arch, v)
    assert ts.kind == "lm" and ts.n_cuts == js.n_cuts
    b = _batch(cfg, 2, seed=v)
    cot = np.random.default_rng(9).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)

    # device side: smashed data and its vjp
    (sm_j, aux_j), vjp = jax.vjp(
        jax.jit(lambda d: js.device_apply(d, _jb(b))), jdev)
    gdev_j, = vjp((jnp.asarray(cot), jnp.zeros((), jnp.float32)))
    dev = _requires_grad(tdev)
    sm, aux = ts.device_apply(dev, _tb(b))
    assert max(_leaf_errs([sm, aux], [sm_j, aux_j])) <= GRAD_TOL
    spec = ts.smashed_spec(2, S)
    assert spec.device.type == "meta" and spec.shape == sm.shape
    gdev = torch.autograd.grad(sm, tree.leaves(dev), torch.from_numpy(cot))
    assert max(_leaf_errs(gdev, jax.tree.leaves(gdev_j))) <= GRAD_TOL

    # server side: loss and gradients in its params and the smashed data
    (loss_j, _), (gsrv_j, gsm_j) = jax.jit(jax.value_and_grad(
        lambda s, x: js.server_loss(s, x, _jb(b)), argnums=(0, 1),
        has_aux=True))(jsrv, sm_j)
    srv = _requires_grad(tsrv)
    smt = sm.detach().requires_grad_()
    loss, aux_s = ts.server_loss(srv, smt, _tb(b))
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    g = _grads(loss, tree.leaves(srv) + [smt])
    assert max(_leaf_errs(g[:-1], jax.tree.leaves(gsrv_j))) <= GRAD_TOL
    assert max(_leaf_errs(g[-1:], [gsm_j])) <= GRAD_TOL

    # export to a standard (untied) model
    jp, jc = js.export(jdev, jsrv)
    tp, tc = ts.export(tdev, tsrv)
    assert tc.tie_embeddings is False and tc == cfg.replace(
        tie_embeddings=False)
    logits_j, _ = jax.jit(lambda p, t: ref.transformer.forward(p, t, jc))(
        jp, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        logits, _ = tfm.forward(tp, torch.from_numpy(b["tokens"]), tc)
    assert max(_leaf_errs([logits], [logits_j])) <= GRAD_TOL


@pytest.mark.parametrize("v", [1, 2])
def test_lm_split_moe_matches_reference(ref, v):
    """Reduced deepseek-v2-lite (MLA, a dense first layer, MoE with shared
    experts): each half's loss + aux and its gradients per leaf, device
    then server, against the reference's split. At v = 1 the device holds
    the dense layer (aux 0); at v = 2 one MoE layer too."""
    js, ts, jdev, jsrv, tdev, tsrv, cfg = _split_pair(
        ref, "deepseek-v2-lite-16b", v)
    b = _batch(cfg, 2, seed=v)
    cot = np.random.default_rng(10).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)

    def jdevice(d):
        sm, aux = js.device_apply(d, _jb(b))
        return jnp.sum(sm * cot) + aux, (sm, aux)

    (_, (sm_j, aux_j)), gdev_j = jax.value_and_grad(
        jdevice, has_aux=True)(jdev)
    dev = _requires_grad(tdev)
    sm, aux = ts.device_apply(dev, _tb(b))
    assert max(_leaf_errs([sm, aux], [sm_j, aux_j])) <= GRAD_TOL
    assert (float(aux.detach()) > 0) == (v > 1)
    gdev = _grads((sm * torch.from_numpy(cot)).sum() + aux,
                  tree.leaves(dev))
    assert max(_leaf_errs(gdev, jax.tree.leaves(gdev_j))) <= GRAD_TOL

    def jserver(s, x):
        loss, aux_s = js.server_loss(s, x, _jb(b))
        return loss + aux_s, aux_s

    (total_j, aux_sj), (gsrv_j, gsm_j) = jax.value_and_grad(
        jserver, argnums=(0, 1), has_aux=True)(jsrv, sm_j)
    srv = _requires_grad(tsrv)
    smt = sm.detach().requires_grad_()
    loss, aux_s = ts.server_loss(srv, smt, _tb(b))
    assert float(aux_s.detach()) > 0
    assert abs(float(aux_s.detach()) - float(aux_sj)) <= 1e-6
    assert float((loss + aux_s).detach()) == pytest.approx(float(total_j),
                                                           rel=1e-6)
    g = _grads(loss + aux_s, tree.leaves(srv) + [smt])
    assert max(_leaf_errs(g[:-1], jax.tree.leaves(gsrv_j))) <= GRAD_TOL
    assert max(_leaf_errs(g[-1:], [gsm_j])) <= GRAD_TOL
    router = srv["stack"][0]["moe"]["router"]
    i = next(i for i, t in enumerate(tree.leaves(srv)) if t is router)
    assert float(g[i].abs().max()) > 0


def test_lm_split_cfgs_follow_the_pattern_offset(ref):
    """gemma2 (local, global) at an odd cut: the server's prologue is the
    global layer, then whole periods; at an even cut, whole periods."""
    from repro_torch.core.splitting import _split_cfgs
    cfg = registry.get("gemma2-2b")
    jcfg = ref.registry.get("gemma2-2b")
    for v in (1, 2, 7, 24, 25):
        dev, srv = _split_cfgs(cfg, v)
        jdev, jsrv = ref.splitting._split_cfgs(jcfg, v)
        assert [s.window for s in dev.layer_specs()] == \
            [s.window for s in jdev.layer_specs()]
        assert [s.window for s in srv.layer_specs()] == \
            [s.window for s in jsrv.layer_specs()]
        assert srv.n_periods == jsrv.n_periods
        assert len(srv.prologue) == v % 2
    with pytest.raises(ValueError, match="out of range"):
        _split_cfgs(cfg, 26)


def test_lm_split_init_shapes_match_reference(ref):
    """The port's own init draws torch numbers, but into the reference's
    tree: same structure, shapes and dtypes."""
    js, ts, jdev, jsrv, _, _, _ = _split_pair(ref, "gemma2-2b", 3)
    gen = torch.Generator().manual_seed(0)
    for jt, tt in ((jdev, ts.init_device(gen)), (jsrv, ts.init_server(gen))):
        jl, tl = jax.tree.leaves(jt), tree.leaves(tt)
        assert [tuple(a.shape) for a in jl] == [tuple(a.shape) for a in tl]
        assert all(t.dtype == torch.float32 for t in tl)


# --------------------------------------------------------------------------
# make_encdec_split (whisper: the cut inside the encoder)
# --------------------------------------------------------------------------

def _encdec_cfgs(ref):
    """Reduced whisper with 3 encoder layers (so the cuts 1 and n_enc - 1
    differ) and 2 decoder layers, f32, remat on (the server's decoder
    checkpoints its blocks; the encoder never does); the port on K1's
    Function, the reference on chunked attention."""
    jcfg = ref.registry.reduce_for_smoke(ref.registry.get("whisper-small"))
    cfg = registry.reduce_for_smoke(registry.get("whisper-small"))
    kw = dict(dtype="float32", n_enc_layers=3, n_layers=5, remat=True)
    return jcfg.replace(**kw), cfg.replace(attn_impl="pallas", **kw)


def _encdec_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}


@pytest.mark.parametrize("v", [1, 2])       # 1 and n_enc - 1
def test_encdec_split_matches_reference(ref, v):
    """Each half's output, loss and gradients (device params through the
    smashed data's cotangent; server params and the smashed data), the
    ``export`` round trip and ``smashed_spec``, against the reference's
    ``make_encdec_split``."""
    from repro_torch.core.splitting import make_encdec_split
    from repro_torch.models import whisper as whp
    jcfg, cfg = _encdec_cfgs(ref)
    js, ts = ref.splitting.make_encdec_split(jcfg, v), make_encdec_split(
        cfg, v)
    assert ts.kind == js.kind == "encdec" and ts.n_cuts == js.n_cuts == 2
    jdev = js.init_device(jax.random.PRNGKey(1))
    jsrv = js.init_server(jax.random.PRNGKey(2))
    tdev = params_from_numpy(jax.device_get(jdev), "cpu")
    tsrv = params_from_numpy(jax.device_get(jsrv), "cpu")
    b = _encdec_batch(cfg, 2, seed=v)
    cot = np.random.default_rng(11).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    (sm_j, aux_j), vjp = jax.vjp(lambda d: js.device_apply(d, _jb(b)), jdev)
    gdev_j, = vjp((jnp.asarray(cot), jnp.zeros((), jnp.float32)))
    dev = _requires_grad(tdev)
    sm, aux = ts.device_apply(dev, _tb(b))
    assert max(_leaf_errs([sm, aux], [sm_j, aux_j])) <= GRAD_TOL
    spec, jspec = ts.smashed_spec(2, S), js.smashed_spec(2, S)
    assert spec.device.type == "meta" and spec.shape == sm.shape
    assert tuple(spec.shape) == tuple(jspec.shape)
    assert str(spec.dtype).split(".")[1] == str(jspec.dtype)
    gdev = torch.autograd.grad(sm, tree.leaves(dev), torch.from_numpy(cot))
    assert max(_leaf_errs(gdev, jax.tree.leaves(gdev_j))) <= GRAD_TOL

    (loss_j, _), (gsrv_j, gsm_j) = jax.value_and_grad(
        lambda s, x: js.server_loss(s, x, _jb(b)), argnums=(0, 1),
        has_aux=True)(jsrv, sm_j)
    srv = _requires_grad(tsrv)
    smt = sm.detach().requires_grad_()
    loss, aux_s = ts.server_loss(srv, smt, _tb(b))
    assert float(aux_s) == 0.0
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    g = _grads(loss, tree.leaves(srv) + [smt])
    assert max(_leaf_errs(g[:-1], jax.tree.leaves(gsrv_j))) <= GRAD_TOL
    assert max(_leaf_errs(g[-1:], [gsm_j])) <= GRAD_TOL

    jp, jc = js.export(jdev, jsrv)
    tp, tc = ts.export(tdev, tsrv)
    assert tc == cfg
    assert max(_leaf_errs(tree.leaves(tp), jax.tree.leaves(jp))) == 0.0
    assert tp["enc_stack"]["attn"]["wq"]["w"].shape[0] == cfg.n_enc_layers
    logits_j, _ = ref.splitting.whp.forward(jp, _jb(b), jc)
    with torch.no_grad():
        logits, _ = api.forward(tp, _tb(b), tc)
        # the split's two halves compose to the assembled model's encoder
        memory = whp.encode(tp, torch.from_numpy(b["frames"]), tc)
        x = whp.enc_blocks(tsrv["enc_stack"], sm.detach(), tc)
    assert max(_leaf_errs([logits], [logits_j])) <= GRAD_TOL
    from repro_torch.models import common as cm
    assert float((cm.apply_norm(tsrv["enc_norm"], x, "layernorm",
                                cfg.norm_eps) - memory).abs().max()) <= 1e-6


def test_encdec_split_refuses_cuts_outside_the_encoder(ref):
    from repro_torch.core.splitting import make_encdec_split, \
        make_split_model
    jcfg, cfg = _encdec_cfgs(ref)
    for v in (0, cfg.n_enc_layers):
        with pytest.raises(ValueError, match="inside the encoder"):
            make_encdec_split(cfg, v)
        with pytest.raises(ValueError, match="inside the encoder"):
            make_split_model(cfg, v)
        with pytest.raises(AssertionError):
            ref.splitting.make_encdec_split(jcfg, v)
    assert make_split_model(cfg, 1).kind == "encdec"


def test_encdec_split_init_shapes_match_reference(ref):
    """The port's own init draws torch numbers into the reference's trees
    (the device's v encoder blocks; the server's whole model with the
    remaining encoder blocks)."""
    from repro_torch.core.splitting import make_encdec_split
    jcfg, cfg = _encdec_cfgs(ref)
    js, ts = ref.splitting.make_encdec_split(jcfg, 2), make_encdec_split(
        cfg, 2)
    gen = torch.Generator().manual_seed(0)
    for jt, tt in ((js.init_device(jax.random.PRNGKey(0)),
                    ts.init_device(gen)),
                   (js.init_server(jax.random.PRNGKey(1)),
                    ts.init_server(gen))):
        jl, tl = jax.tree.leaves(jt), tree.leaves(tt)
        assert [tuple(a.shape) for a in jl] == [tuple(a.shape) for a in tl]
        assert all(t.dtype == torch.float32 for t in tl)
