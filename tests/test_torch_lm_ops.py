"""Port parity for the split-LM training slice's differentiable kernels
and losses, against the JAX reference on the CPU.

- K1's ``autograd.Function`` (``kernels/flash_attention/ops.py``) against
  the reference's ``custom_vjp`` (the Pallas kernel in interpret mode
  forward, chunked jnp backward): the output and dq/dk/dv.
- The port's ``chunked_attention`` flash backward against the reference's.
- K2's ``autograd.Function`` (``kernels/ssd/ops.py``, B and C per group)
  against the reference's (per head): dx, ddt, dA, and dB/dC with the
  reference's per-head gradients summed over each group's heads; and
  ``ssd_chunked``'s gradient.
- ``lm_head_loss``: the value, dx and dW, full and chunked (the fused
  cross-entropy with its hand-written backward), masked or not, with the
  final softcap.
- The kernel wrappers refuse an input that requires grad in grad mode.

On the CPU the kernel wrappers compute their plain versions, so these
tests hold the Functions' plumbing (layouts, group sums, None
cotangents) to the reference; the kernels' own gradients are checked on
the card by ``tests/test_torch_cuda.py`` and
``tests/test_torch_cuda_models.py``. Inputs are numpy
arrays from fixed seeds, float32 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb

FA_TOL = 1e-4        # tests/test_kernels.py:72, flash grads in f32
SSD_TOL = 2e-5       # tests/test_kernels.py:142, SSD grads in f32
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(t, j, tol, what=""):
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max()) if t.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(j).max())), (what, err)


# --------------------------------------------------------------------------
# K1: flash attention
# --------------------------------------------------------------------------

# (B, Sq, Skv, G, R, D, causal, window, softcap, q_offset)
FA_CASES = [
    (2, 32, 64, 2, 2, 16, True, 24, 50.0, 32),    # GQA R=2, all features
    (2, 48, 48, 2, 2, 16, True, 0, 50.0, 0),      # gemma2's global layer
    (1, 32, 32, 1, 3, 8, True, 12, 0.0, 0),       # local window, R=3
    (2, 16, 32, 2, 1, 8, False, 0, 0.0, 0),       # cross-attention shape
]


def _fa_inputs(case, seed=0):
    B, Sq, Skv, G, R, D = case[:6]
    return _np(seed, (B, Sq, G, R, D), (B, Skv, G, D), (B, Skv, G, D),
               (B, Sq, G, R, D))


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_function_matches_reference_vjp(ref, case):
    causal, window, softcap, q_offset = case[6:]
    q, k, v, g = _fa_inputs(case)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_: ref.fa_ops.flash_attention(
            q_, k_, v_, causal, window, softcap, q_offset),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = fa_ops.flash_attention(qt, kt, vt, causal, window, softcap,
                                 q_offset)
    assert out.grad_fn is not None
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), _t(g))
    _close(out, out_j, FA_TOL, "out")
    for a, b, n in ((dq, dq_j, "dq"), (dk, dk_j, "dk"), (dv, dv_j, "dv")):
        _close(a, b, FA_TOL, n)


@pytest.mark.parametrize("case", FA_CASES)
def test_chunked_attention_grads_match_reference(ref, case):
    """The plain flash backward (the K1 Function's recomputation) with
    small tiles, so masked tiles are skipped and rows span tiles."""
    causal, window, softcap, q_offset = case[6:]
    q, k, v, g = _fa_inputs(case, seed=1)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_: ref.common.chunked_attention(
            q_, k_, v_, causal, window, softcap, q_offset, 8, 8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = cm.chunked_attention(qt, kt, vt, causal, window, softcap,
                               q_offset, 8, 8)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(g))
    _close(out, out_j, 1e-5, "out")
    for a, b, n in zip(grads, grads_j, ("dq", "dk", "dv")):
        _close(a, b, FA_TOL, n)


def test_chunked_attention_with_skipped_tiles_matches_naive():
    """Small tiles, so the window and the causal mask hide whole tiles
    that the loop skips: the output still equals the full
    materialisation."""
    q, k, v, _ = _fa_inputs(FA_CASES[0], seed=2)
    args = (True, 24, 50.0, 32)
    with torch.no_grad():
        tiled = cm.chunked_attention(_t(q), _t(k), _t(v), *args, 8, 8)
        naive = cm.naive_attention(_t(q), _t(k), _t(v), causal=True,
                                   window=24, softcap=50.0, q_offset=32)
    assert float((tiled - naive).abs().max()) < 1e-5


# --------------------------------------------------------------------------
# K2: the SSD scan
# --------------------------------------------------------------------------

def _ssd_inputs(B_=2, S=24, H=4, G=2, P=16, N=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, S, H)) - 1.0)
                  ).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bg = (0.5 * rng.standard_normal((B_, S, G, N))).astype(np.float32)
    Cg = (0.5 * rng.standard_normal((B_, S, G, N))).astype(np.float32)
    gy = rng.standard_normal((B_, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B_, H, N, P)).astype(np.float32)
    return x, dt, A, Bg, Cg, gy, gh


def _per_head(t, H):
    B_, S, G, N = t.shape
    return np.repeat(t, H // G, axis=2)


def _group_sum(t, G):
    B_, S, H, N = t.shape
    return np.asarray(t).reshape(B_, S, G, H // G, N).sum(3)


@pytest.mark.parametrize("with_state_grad", [True, False])
def test_ssd_function_matches_reference_vjp(ref, with_state_grad):
    x, dt, A, Bg, Cg, gy, gh = _ssd_inputs()
    H, G = x.shape[2], Bg.shape[2]
    (y_j, h_j), vjp = jax.vjp(
        lambda *a: ref.ssd_ops.ssd(*a, 8),
        *map(jnp.asarray, (x, dt, A, _per_head(Bg, H), _per_head(Cg, H))))
    gh_in = gh if with_state_grad else np.zeros_like(gh)
    dx_j, ddt_j, dA_j, dB_j, dC_j = vjp((jnp.asarray(gy),
                                         jnp.asarray(gh_in)))
    ins = [_t(a, True) for a in (x, dt, A, Bg, Cg)]
    y, hT = ssd_ops.ssd(*ins, chunk=8)
    assert y.grad_fn is not None and hT.grad_fn is not None
    _close(y, y_j, SSD_TOL, "y")
    _close(hT, h_j, SSD_TOL, "hT")
    outs, cots = ((y, hT), (_t(gy), _t(gh))) if with_state_grad else \
        ((y,), (_t(gy),))
    dx, ddt, dA, dB, dC = torch.autograd.grad(outs, ins, cots)
    _close(dx, dx_j, SSD_TOL, "dx")
    _close(ddt, ddt_j, SSD_TOL, "ddt")
    _close(dA, dA_j, SSD_TOL, "dA")
    _close(dB, _group_sum(dB_j, G), SSD_TOL, "dB")
    _close(dC, _group_sum(dC_j, G), SSD_TOL, "dC")


def test_ssd_function_state_grad_only():
    """A backward that reaches only hT (y's cotangent None)."""
    x, dt, A, Bg, Cg, _, gh = _ssd_inputs(seed=4)
    ins = [_t(a, True) for a in (x, dt, A, Bg, Cg)]
    _, hT = ssd_ops.ssd(*ins, chunk=8)
    grads = torch.autograd.grad((hT * _t(gh)).sum(), ins, allow_unused=True)
    ins2 = [_t(a, True) for a in (x, dt, A, Bg, Cg)]
    H = x.shape[2]
    _, hT2 = mb.ssd_chunked(ins2[0], ins2[1], ins2[2],
                            mb._broadcast_groups(ins2[3], H),
                            mb._broadcast_groups(ins2[4], H), chunk=8)
    grads2 = torch.autograd.grad((hT2 * _t(gh)).sum(), ins2,
                                 allow_unused=True)
    assert grads[4] is None and grads2[4] is None   # hT does not read C
    for a, b in zip(grads[:4], grads2[:4]):
        assert torch.equal(a, b)


def test_ssd_chunked_grads_match_reference(ref):
    x, dt, A, Bg, Cg, gy, gh = _ssd_inputs(seed=5)
    H = x.shape[2]
    Bh, Ch = _per_head(Bg, H), _per_head(Cg, H)
    (y_j, h_j), vjp = jax.vjp(
        lambda *a: ref.mamba2.ssd_chunked(*a, chunk=8),
        *map(jnp.asarray, (x, dt, A, Bh, Ch)))
    grads_j = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [_t(a, True) for a in (x, dt, A, Bh, Ch)]
    y, hT = mb.ssd_chunked(*ins, chunk=8)
    grads = torch.autograd.grad((y, hT), ins, (_t(gy), _t(gh)))
    _close(y, y_j, SSD_TOL, "y")
    for a, b, n in zip(grads, grads_j, ("dx", "ddt", "dA", "dB", "dC")):
        _close(a, b, SSD_TOL, n)


def test_ssd_chunked_grads_stay_finite_under_large_decays():
    """A chunk whose decay sum exceeds exp's range (dt * |A| ~ 20 a step,
    as mamba2-2.7b's A up to 16 gives): above the diagonal the
    difference of cumsums overflows, and masking after the exp would
    make its gradient inf * 0 = NaN. The gradients stay finite and equal
    the sequential scan's."""
    rng = np.random.default_rng(13)
    B_, S_, H, P, N = 1, 64, 2, 4, 4
    x, Bm, Cm = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B_, S_, H, P), (B_, S_, H, N), (B_, S_, H, N)))
    dt = (1.0 + 2.0 * rng.random((B_, S_, H))).astype(np.float32)
    A = np.full((H,), -10.0, np.float32)
    grads = []
    for fn in (lambda *a: mb.ssd_chunked(*a, chunk=32), mb.ssd_scan):
        ins = [_t(a, True) for a in (x, dt, A, Bm, Cm)]
        y, hT = fn(*ins)
        grads.append(torch.autograd.grad(y.sum() + hT.sum(), ins))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        # chunked vs sequential sums at dt ~ 2: 5.6e-5 measured, so twice
        # tests/test_kernels.py's 5e-5 for the chunked forward vs the scan
        _close(a, b.numpy(), 1e-4)


def test_ssd_chunked_recomputes_chunks_in_backward():
    """Under autograd every chunk body is checkpointed: the graph keeps
    no (B, H, Q, Q) tile, and the gradients equal an unchecked run's
    (the same ops in the same order)."""
    x, dt, A, Bg, Cg, gy, _ = _ssd_inputs(seed=6)
    H = x.shape[2]
    Bh, Ch = _per_head(Bg, H), _per_head(Cg, H)
    ins = [_t(a, True) for a in (x, dt, A, Bh, Ch)]
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = mb.ssd_chunked(*ins, chunk=8)
    Q = 8
    assert not any(len(s) == 4 and s[2:] == (Q, Q) for s in shapes)
    grads = torch.autograd.grad(y, ins, _t(gy))
    with torch.no_grad():
        y_ref, _ = mb.ssd_chunked(*[t.detach() for t in ins], chunk=8)
    assert torch.equal(y.detach(), y_ref)
    assert all(torch.isfinite(g).all() for g in grads)


# --------------------------------------------------------------------------
# the wrappers' guards
# --------------------------------------------------------------------------

def test_kernel_wrappers_refuse_inputs_that_require_grad():
    q, k, v = _np(7, (2, 16, 8), (2, 16, 8), (2, 16, 8))
    with pytest.raises(RuntimeError, match="requires grad"):
        fk.flash_attention_flat(_t(q, True), _t(k), _t(v))
    x, dt, A, Bg, Cg, _, _ = _ssd_inputs(seed=8)
    with pytest.raises(RuntimeError, match="requires grad"):
        sk.ssd_grouped(_t(x), _t(dt, True), _t(A), _t(Bg), _t(Cg), chunk=8)
    with torch.no_grad():      # inference and the Functions' forwards
        fk.flash_attention_flat(_t(q, True), _t(k), _t(v))
        sk.ssd_grouped(_t(x), _t(dt, True), _t(A), _t(Bg), _t(Cg), chunk=8)


# --------------------------------------------------------------------------
# the LM head's loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("softcap", [30.0, 0.0])
def test_lm_head_loss_matches_reference(ref, chunk, masked, softcap):
    B, S, D, V = 2, 16, 64, 211
    x, w = _np(9, (B, S, D), (D, V))
    rng = np.random.default_rng(10)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    kw = dict(dtype="float32", loss_chunk=chunk, final_softcap=softcap)
    jcfg = ref.registry.reduce_for_smoke(
        ref.registry.get("gemma2-2b")).replace(**kw)
    cfg = registry.reduce_for_smoke(registry.get("gemma2-2b")).replace(**kw)
    jm = None if mask is None else jnp.asarray(mask)
    loss_j, (dw_j, dx_j) = jax.value_and_grad(
        lambda w_, x_: ref.common.lm_head_loss(w_, x_, jnp.asarray(labels),
                                               jcfg, jm), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(x))
    wt, xt = _t(w, True), _t(x, True)
    loss = cm.lm_head_loss(wt, xt, _t(labels), cfg,
                           None if mask is None else _t(mask))
    dw, dx = torch.autograd.grad(loss, (wt, xt))
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=LOSS_TOL)
    _close(dw, dw_j, LOSS_TOL, "dW")
    _close(dx, dx_j, LOSS_TOL, "dx")


def test_cross_entropy_matches_reference(ref):
    logits, = _np(11, (3, 5, 17))
    labels = np.random.default_rng(12).integers(0, 17, (3, 5))
    mask = (np.arange(15).reshape(3, 5) % 3 > 0).astype(np.float32)
    for m in (None, mask):
        j = ref.common.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        t = cm.cross_entropy(_t(logits), _t(labels),
                             None if m is None else _t(m))
        assert float(t) == pytest.approx(float(j), rel=1e-6)
