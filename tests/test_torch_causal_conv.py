"""The Mamba-2 mixer's conv stage (``kernels/causal_conv``) on the CPU: the
plain version against the mixer's former expression, the mixer reading
xBC in place against its former cat, the kernel's backward in closed form
against autograd, and the wrappers' ``meta`` paths and refusals. The
kernels themselves run on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import streams, telemetry, tree
from repro_torch.configs import registry
from repro_torch.kernels.causal_conv import kernel as ck
from repro_torch.kernels.causal_conv import ops as c_ops
from repro_torch.kernels.causal_conv.ref import (causal_conv_bwd_ref,
                                                 causal_conv_silu_ref)
from repro_torch.models import mamba2 as mb

K = 4


def _former_conv(x, w, b):
    """``models/mamba2.py``'s conv stage before the kernel, op for op."""
    Kw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, Kw - 1, 0))
    y = sum(xp[:, k:k + S, :] * w[k].to(x.dtype) for k in range(Kw))
    return F.silu(y + b.to(x.dtype))


def _inputs(B_, S, C, dtype, seed=0, Kw=K):
    """x as the mixer has it, a column slice of wider rows (in_proj's
    output); w and b as f32 parameters."""
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn((B_, S, C + 40), generator=g).to(dtype)
    w = torch.randn((Kw, C), generator=g) / 2
    b = torch.randn((C,), generator=g)
    return wide[..., 24:24 + C], w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [K - 1, K, 37])
def test_plain_is_the_former_expression(S, dtype):
    """Bit-equal, forward and every gradient, on a strided x of two
    sequences: the CPU path keeps its readings."""
    ins = _inputs(2, S, 48, dtype)
    g = torch.Generator().manual_seed(1)
    outs, grads = [], []
    for fn in (_former_conv, causal_conv_silu_ref):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        out = fn(*leaves)
        out.backward(torch.randn(out.shape, generator=g.manual_seed(1))
                     .to(dtype))
        outs.append(out)
        grads.append([t.grad for t in leaves])
    assert outs[0].dtype == dtype and outs[0].shape == (2, S, 48)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- the mixer reads xBC in place -------------------------------------------

def _mixer(dtype="float32"):
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype=dtype, ssd_impl="pallas")
    params = mb.mamba_init(streams.model_generator(0, "cpu"), cfg)
    return cfg, params


def _former_split(zxbcdt, cfg):
    """in_proj's output split five ways and xBC rebuilt by a cat, as the
    mixer did before it read the slice: (z, xBC, dt)."""
    s = cfg.ssm
    d_inner, H, _ = mb.mamba_dims(cfg)
    gn = s.ngroups * s.d_state
    z, xin, B_r, C_r, dtr = torch.split(zxbcdt, [d_inner, d_inner, gn, gn, H],
                                        dim=-1)
    return z, torch.cat([xin, B_r, C_r], dim=-1), dtr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_reads_the_slice_the_cat_rebuilt(monkeypatch, dtype):
    """xBC is in_proj's column slice, bit-equal to the former cat and a
    view of in_proj's output (nothing copied); the output, the conv state,
    the SSM state and the gradients of x and of every parameter are the
    former mixer's bit for bit."""
    cfg, p = _mixer(dtype)
    x = torch.randn((2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).to(
        getattr(torch, dtype))
    seen = []
    conv = mb.conv_silu

    def spy(xbc, p_, cfg_):
        seen.append(xbc)
        return conv(xbc, p_, cfg_)

    monkeypatch.setattr(mb, "conv_silu", spy)

    def run():
        leaves = tree.map(lambda t: t.detach().clone().requires_grad_(), p)
        xl = x.clone().requires_grad_()
        out, (cstate, h) = mb.mamba_apply(leaves, xl, cfg, return_state=True)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [xl] + tree.leaves(leaves))
        return [out, cstate, h, *grads]

    got = run()
    monkeypatch.setattr(mb, "_split_proj", _former_split)
    want = run()
    xbc, former = seen
    assert xbc.stride(-1) == 1 and xbc.stride(-2) > xbc.shape[-1]
    assert former.is_contiguous()
    assert torch.equal(xbc, former)
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mamba_decode_step_reads_the_slice_the_cat_rebuilt(monkeypatch):
    """The decode step's conv input is the same column slice: the output
    and the cache it writes are the former cat's bit for bit."""
    cfg, p = _mixer()
    x1 = torch.randn((2, 1, cfg.d_model),
                     generator=torch.Generator().manual_seed(4))
    cache = mb.mamba_init_cache(cfg, 2, torch.float32)
    cache["conv"].normal_(generator=torch.Generator().manual_seed(5))
    cache["ssm"].normal_(generator=torch.Generator().manual_seed(6))
    former_cache = {k: v.clone() for k, v in cache.items()}
    out, _ = mb.mamba_decode_step(p, x1, cache, cfg)
    monkeypatch.setattr(mb, "_split_proj", _former_split)
    want, _ = mb.mamba_decode_step(p, x1, former_cache, cfg)
    assert torch.equal(out, want)
    for name in ("conv", "ssm"):
        assert torch.equal(cache[name], former_cache[name])


# -- the kernel's backward in closed form -----------------------------------

def _autograd_f64(x, w, b, dy):
    leaves = [t.detach().double().requires_grad_() for t in (x, w, b)]
    out = causal_conv_silu_ref(*leaves)
    return torch.autograd.grad(out, leaves, dy.double())


@pytest.mark.parametrize("Kw", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [1, 3, 37])
def test_closed_form_backward_is_autograd_in_f64(S, Kw):
    """``causal_conv_bwd_ref`` (the kernel's arithmetic) against autograd
    of the plain version, in f64, with x a strided view of 3 sequences."""
    x, w, b = (t.double() for t in _inputs(3, S, 40, torch.float64, seed=2,
                                           Kw=Kw))
    assert x.stride(1) != 40                    # a column slice
    dy = torch.randn(x.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(3))
    want = _autograd_f64(x, w, b, dy)
    got = causal_conv_bwd_ref(x, w, b, dy)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        assert a.shape == c.shape and a.dtype == torch.float64, name
        err = float((a - c).abs().max() / c.abs().max())
        assert err < 1e-12, (name, err)


def test_closed_form_backward_keeps_the_rows_dtype():
    x, w, b = _inputs(2, 9, 16, torch.bfloat16, seed=5)
    dx, dw, db = causal_conv_bwd_ref(x, w, b, torch.ones_like(x))
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (K, 16) and db.shape == (16,)


def test_each_sequence_starts_from_zeros():
    """Row b's first K - 1 outputs see zeros before them, not row b - 1's
    tail: the batch conv equals each sequence convolved alone."""
    x, w, b = _inputs(3, 7, 16, torch.float32, seed=6)
    y = causal_conv_silu_ref(x, w, b)
    for i in range(3):
        assert torch.equal(y[i:i + 1], causal_conv_silu_ref(x[i:i + 1], w,
                                                            b))


# -- the wrappers ------------------------------------------------------------

class _Calls:
    def __init__(self):
        self.calls = []

    def custom_call(self, name, operands, results):
        self.calls.append((name, [tuple(t.shape) for t in operands],
                           [(tuple(t.shape), t.dtype) for t in results]))


def _meta(B_=2, S=64, C=160, dtype=torch.bfloat16, width=296):
    m = dict(device="meta")
    x = torch.empty((B_, S, width), dtype=dtype, **m)[..., 64:64 + C]
    return x, torch.empty((K, C), **m), torch.empty((C,), **m)


def _recording(fn):
    rec = _Calls()
    telemetry.observers.append(rec)
    try:
        with telemetry.LaunchCounter() as n:
            out = fn()
    finally:
        telemetry.observers.remove(rec)
    return out, rec.calls, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_forward_allocates_and_reports(dtype):
    x, w, b = _meta(dtype=dtype)
    y, calls, n = _recording(lambda: ck.causal_conv_fwd(x, w, b))
    assert (y.shape, y.dtype, y.device.type) == ((2, 64, 160), dtype, "meta")
    assert y.is_contiguous()
    assert calls == [("causal_conv", [(2, 64, 160), (K, 160), (160,)],
                      [((2, 64, 160), dtype)])]
    assert n["causal_conv"] == 0           # meta launches nothing


def test_meta_backward_allocates_and_reports():
    x, w, b = _meta()
    dy = torch.empty(x.shape, dtype=x.dtype, device="meta")
    grads, calls, n = _recording(lambda: ck.causal_conv_bwd(x, w, b, dy))
    BF, F32 = torch.bfloat16, torch.float32
    assert [(tuple(t.shape), t.dtype) for t in grads] == [
        ((2, 64, 160), BF), ((K, 160), F32), ((160,), F32)]
    assert calls == [("causal_conv_bwd", [(2, 64, 160), (K, 160), (160,),
                                          (2, 64, 160)],
                      [((2, 64, 160), BF), ((K, 160), F32), ((160,), F32)])]
    assert n["causal_conv_bwd"] == 0
    # a row of partials a block down the rows: one a tile of 64 rows, up to
    # a wave of the H100's resident blocks
    BF16, F32 = torch.bfloat16, torch.float32
    assert ck.bwd_rows(2, 64, 160, BF16) == 2
    assert ck.bwd_rows(3, 257, 160, BF16) == 15
    assert ck.bwd_rows(4, 4096, 5376, BF16) == 528 // 84 == 6
    assert ck.bwd_rows(4, 4096, 5376, F32) == 528 // 168 == 3
    assert ck.bwd_rows(1, 1, 10 ** 6, BF16) == 1


def test_function_on_meta_takes_the_kernels():
    """Forward and backward through the Function on meta: one call of each
    kernel, gradients of the inputs' shapes (x a column slice)."""
    base = torch.empty((2, 64, 296), dtype=torch.bfloat16, device="meta",
                       requires_grad=True)
    _, w, b = _meta()
    leaves = [t.requires_grad_() for t in (w, b)]

    def step():
        out = c_ops.causal_conv_silu(base[..., 64:224], *leaves)
        return torch.autograd.grad(out.sum(), [base] + leaves)

    grads, calls, _ = _recording(step)
    assert [c[0] for c in calls] == ["causal_conv", "causal_conv_bwd"]
    assert [tuple(g.shape) for g in grads] == [(2, 64, 296), (K, 160),
                                               (160,)]
    assert grads[1].dtype == grads[2].dtype == torch.float32


def test_function_takes_the_plain_version_on_the_cpu():
    ins = _inputs(2, 9, 16, torch.float32, seed=7)
    (out, calls, _) = _recording(lambda: c_ops.causal_conv_silu(*ins))
    assert calls == []
    assert torch.equal(out, causal_conv_silu_ref(*ins))


def test_wrappers_refuse_what_the_kernel_cannot_read():
    x, w, b = _meta()
    with pytest.raises(ValueError, match="no causal conv kernel"):
        ck.causal_conv_fwd(*_inputs(2, 9, 16, torch.float32))
    with pytest.raises(ValueError, match="unit last stride"):
        ck.causal_conv_fwd(x.new_empty((2, 64, 320))[..., ::2], w, b)
    with pytest.raises(ValueError, match="at most 4"):
        ck.causal_conv_fwd(x, torch.empty((5, 160), device="meta"), b)
    with pytest.raises(ValueError, match="at most 4"):
        ck.causal_conv_fwd(x, w, torch.empty((161,), device="meta"))
    with pytest.raises(ValueError, match="at most 4"):
        ck.causal_conv_fwd(x[0], w, b)                # not (B, S, C)
    with pytest.raises(TypeError, match="share"):
        ck.causal_conv_fwd(x, w, b.bfloat16())         # w and b differ
    with pytest.raises(TypeError, match="share"):
        ck.causal_conv_fwd(x.half(), w, b)
    with pytest.raises(ValueError, match="different devices"):
        ck.causal_conv_fwd(x, torch.empty((K, 160)), b)
    dy = torch.empty(x.shape, dtype=x.dtype, device="meta")
    with pytest.raises(ValueError, match="dy must"):
        ck.causal_conv_bwd(x, w, b, dy.float())        # x is bf16
    with pytest.raises(ValueError, match="dy must"):
        ck.causal_conv_bwd(x, w, b, x)                 # not contiguous
    with pytest.raises(ValueError, match="dy must"):
        ck.causal_conv_bwd(x, w, b, dy[:, :32])
    # any batch and row strides with a unit last stride are read in place
    assert ck.causal_conv_fwd(x[:, ::2], w, b).shape == (2, 32, 160)
    assert ck.causal_conv_bwd(x, w, b, dy)[0].shape == x.shape


def test_wrappers_refuse_inputs_that_require_grad():
    x, w, b = _meta()
    with pytest.raises(RuntimeError, match="requires grad"):
        ck.causal_conv_fwd(x, w.requires_grad_(), b)
    dy = torch.empty(x.shape, dtype=x.dtype, device="meta")
    with pytest.raises(RuntimeError, match="requires grad"):
        ck.causal_conv_bwd(x, w, b, dy)
