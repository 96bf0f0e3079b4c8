"""The Mamba-2 mixer's gated output stage (``kernels/gated_norm``) on the
CPU: the plain version against the mixer's former expression, the
kernel's backward in closed form against autograd, and the wrappers'
``meta`` paths and refusals. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.kernels.gated_norm import kernel as gk
from repro_torch.kernels.gated_norm import ops as g_ops
from repro_torch.kernels.gated_norm.ref import (gated_norm_bwd_ref,
                                                gated_norm_ref)
from repro_torch.models.common import apply_norm

EPS = 1e-5
# (W, H): mamba2-2.7b's d_inner over 80 heads, granite's over 128, a small
# one over 8 heads of 16
WIDTHS = [(5120, 80), (8192, 128), (128, 8)]


def _inputs(lead, W, H, dtype, seed=0, extra=24):
    """y (lead, H, P) contiguous; x and z as the mixer has them: column
    slices of wider packed rows (the conv's output per head, in_proj's
    output); D (H,) and scale (W,) as f32 parameters."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    y = rnd(*lead, H, W // H)
    xbc = rnd(*lead, W + extra)
    zx = rnd(*lead, 2 * W + extra + H)
    D = 1.0 + 0.5 * torch.randn((H,), generator=g)
    scale = 1.0 + 0.1 * torch.randn((W,), generator=g)
    return y, xbc[..., :W].reshape(y.shape), zx[..., :W], D, scale


def _former(y, x, z, D, scale, eps):
    """``models/mamba2.py``'s stage before the kernel, op for op: y and the
    skip per head, the gate, ``apply_norm``."""
    y = y + x * D.to(y.dtype)[:, None]
    y = y.reshape(z.shape)
    return apply_norm({"scale": scale}, y * F.silu(z), "rmsnorm", eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,H", WIDTHS[:2])
@pytest.mark.parametrize("lead", [(2, 3), (4,)])
def test_plain_is_the_former_expression(lead, W, H, dtype):
    """Bit-equal, forward and every gradient: the CPU path keeps its
    readings (training forward (B, S, W) and decode (B, W) rows)."""
    ins = _inputs(lead, W, H, dtype)
    outs, grads = [], []
    for fn in (_former, gated_norm_ref):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        out = fn(*leaves, EPS)
        out.backward(torch.ones_like(out) + torch.arange(
            out.numel(), dtype=torch.float32).reshape(out.shape).sin()
            .to(dtype))
        outs.append(out)
        grads.append([t.grad for t in leaves])
    assert outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _autograd_f64(y, x, z, D, scale, dout, eps):
    leaves = [t.detach().double().requires_grad_() for t in (y, x, z, D,
                                                             scale)]
    out = gated_norm_ref(*leaves, eps)
    return torch.autograd.grad(out, leaves, dout.double())


def _rstd(y, x, z, D, eps):
    g = (y + x * D[:, None]).reshape(z.shape) * F.silu(z)
    return torch.rsqrt((g * g).mean(-1) + eps).reshape(-1)


@pytest.mark.parametrize("W,H", WIDTHS)
@pytest.mark.parametrize("lead", [(2, 5), (3,)])
def test_closed_form_backward_is_autograd_in_f64(lead, W, H):
    """``gated_norm_bwd_ref`` (the kernel's arithmetic) against autograd
    of the plain version, in f64, with x and z strided views."""
    ins = [t.double() if t.dtype.is_floating_point else t
           for t in _inputs(lead, W, H, torch.float64, seed=1)]
    y, x, z, D, scale = ins
    assert x.stride(-3) != W and z.stride(-2) != W     # column slices
    dout = torch.randn(z.shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    want = _autograd_f64(y, x, z, D, scale, dout, EPS)
    got = gated_norm_bwd_ref(y, x, z, D, scale, _rstd(y, x, z, D, EPS),
                             dout)
    for name, a, b in zip(("dy", "dx", "dz", "dD", "dscale"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float64, name
        err = float((a - b).abs().max() / b.abs().max())
        assert err < 1e-12, (name, err)


def test_closed_form_backward_keeps_the_rows_dtype():
    y, x, z, D, scale = _inputs((2, 4), 128, 8, torch.bfloat16, seed=3)
    rstd = _rstd(y.float(), x.float(), z.float(), D, EPS)
    dy, dx, dz, dD, dscale = gated_norm_bwd_ref(y, x, z, D, scale, rstd,
                                                torch.ones_like(z))
    assert {dy.dtype, dx.dtype, dz.dtype} == {torch.bfloat16}
    assert dD.dtype == dscale.dtype == torch.float32
    assert dy.shape == dx.shape == y.shape and dz.shape == z.shape
    assert dD.shape == (8,) and dscale.shape == (128,)


class _Calls:
    def __init__(self):
        self.calls = []

    def custom_call(self, name, operands, results):
        self.calls.append((name, [tuple(t.shape) for t in operands],
                           [(tuple(t.shape), t.dtype) for t in results]))


def _meta(lead=(2, 64), W=256, H=4, dtype=torch.bfloat16):
    m = dict(device="meta")
    y = torch.empty((*lead, H, W // H), dtype=dtype, **m)
    xbc = torch.empty((*lead, W + 64), dtype=dtype, **m)
    zx = torch.empty((*lead, 2 * W + 80), dtype=dtype, **m)
    return (y, xbc[..., :W].reshape(y.shape), zx[..., :W],
            torch.empty((H,), **m), torch.empty((W,), **m))


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
    y, x, z, D, scale = _meta(dtype=dtype)
    (out, rstd), calls, n = _recording(
        lambda: gk.gated_norm_fwd(y, x, z, D, scale, EPS))
    assert (out.shape, out.dtype, out.device.type) == (z.shape, dtype,
                                                       "meta")
    assert (rstd.shape, rstd.dtype) == ((128,), torch.float32)
    assert calls == [("gated_norm", [(2, 64, 4, 64)] * 2 + [
        (2, 64, 256), (4,), (256,)], [((2, 64, 256), dtype),
                                      ((128,), torch.float32)])]
    assert n["gated_norm"] == 0           # meta launches nothing


def test_meta_backward_allocates_and_reports():
    y, x, z, D, scale = _meta()
    rstd = torch.empty((128,), device="meta")
    dout = torch.empty(z.shape, dtype=y.dtype, device="meta")
    grads, calls, n = _recording(
        lambda: gk.gated_norm_bwd(y, x, z, D, scale, rstd, dout))
    BF, F32 = torch.bfloat16, torch.float32
    assert [(tuple(t.shape), t.dtype) for t in grads] == [
        ((2, 64, 4, 64), BF)] * 2 + [((2, 64, 256), BF), ((4,), F32),
                                     ((256,), F32)]
    assert [c[0] for c in calls] == ["gated_norm_bwd"]
    assert n["gated_norm_bwd"] == 0


def test_function_on_meta_takes_the_kernels():
    """Forward and backward through the Function on meta: one call of each
    kernel, gradients of the inputs' shapes (x and z strided)."""
    y, x, z, D, scale = _meta()
    base = torch.empty((2, 64, 320), dtype=torch.bfloat16, device="meta",
                       requires_grad=True)
    leaves = [t.requires_grad_() for t in (y, D, scale)]

    def step():
        x2 = base[..., :256]
        out = g_ops.gated_norm(leaves[0], x2.reshape(y.shape), x2 * 2,
                               leaves[1], leaves[2], EPS)
        return torch.autograd.grad(out.sum(), [base] + leaves)

    grads, calls, _ = _recording(step)
    assert [c[0] for c in calls] == ["gated_norm", "gated_norm_bwd"]
    assert [tuple(g.shape) for g in grads] == [(2, 64, 320), (2, 64, 4, 64),
                                               (4,), (256,)]
    assert grads[2].dtype == grads[3].dtype == torch.float32


def test_function_takes_the_plain_version_on_the_cpu():
    ins = _inputs((2, 3), 128, 8, torch.float32, seed=4)
    (out, calls, _) = _recording(lambda: g_ops.gated_norm(*ins, EPS))
    assert calls == []
    assert torch.equal(out, gated_norm_ref(*ins, EPS))


def test_wrappers_refuse_what_the_kernel_cannot_read():
    y, x, z, D, scale = _meta()
    with pytest.raises(ValueError, match="no gated norm kernel"):
        gk.gated_norm_fwd(*_inputs((2,), 128, 8, torch.float32), EPS)
    heads = y.shape

    def bad(shape, cut):
        return cut(y.new_empty(shape)).reshape(heads)

    with pytest.raises(ValueError, match="16-byte"):
        gk.gated_norm_fwd(y, bad((2, 64, 257), lambda t: t[..., 1:]), z, D,
                          scale, EPS)                  # misaligned base
    with pytest.raises(ValueError, match="16-byte"):
        gk.gated_norm_fwd(y, bad((2, 64, 261), lambda t: t[..., :256]), z,
                          D, scale, EPS)               # row stride 261
    with pytest.raises(ValueError, match="16-byte"):
        gk.gated_norm_fwd(y, bad((2, 64, 512), lambda t: t[..., ::2]), z, D,
                          scale, EPS)                  # last stride 2
    with pytest.raises(ValueError, match="flatten"):
        gk.gated_norm_fwd(y, y.new_empty((64, 2, 4, 64)).transpose(0, 1), z,
                          D, scale, EPS)
    with pytest.raises(ValueError, match="multiple"):
        gk.gated_norm_fwd(y, x, z, torch.empty((3,), device="meta"),
                          scale, EPS)                  # D is not (H,)
    y4 = y.new_empty((2, 64, 64, 4))
    with pytest.raises(ValueError, match="multiple"):
        gk.gated_norm_fwd(y4, y4, z, torch.empty((64,), device="meta"),
                          scale, EPS)                  # heads of 4
    with pytest.raises(TypeError, match="share"):
        gk.gated_norm_fwd(y, x.float(), z, D, scale, EPS)
    rstd = torch.empty((128,), device="meta")
    with pytest.raises(ValueError, match="rstd"):
        gk.gated_norm_bwd(y, x, z, D, scale, rstd[:64], torch.empty_like(z))
    # dout is read at its strides as y, x and z are
    with pytest.raises(ValueError, match="16-byte"):
        gk.gated_norm_bwd(y, x, z, D, scale, rstd,
                          y.new_empty((2, 64, 257))[..., 1:])
    grads = gk.gated_norm_bwd(y, x, z, D, scale, rstd, torch.empty_like(z))
    assert grads[0].shape == y.shape


def test_wrappers_refuse_inputs_that_require_grad():
    y, x, z, D, scale = _meta()
    with pytest.raises(RuntimeError, match="requires grad"):
        gk.gated_norm_fwd(y.requires_grad_(), x, z, D, scale, EPS)


# -- the JAX package's mixer, saved for the card (tests/_mamba_jax_ref.py) --

def test_jax_mixer_fixture_is_what_the_reference_computes():
    import numpy as np
    import _mamba_jax_ref as jref
    now = jref.compute()
    with np.load(jref.FIXTURE) as f:
        assert sorted(f.files) == sorted(now)
        for name in f.files:
            np.testing.assert_allclose(f[name], now[name], rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_port_mixer_on_the_cpu_meets_the_jax_fixture():
    """The fixture read as the card test reads it, through the port's
    mixer on the CPU (the plain stage): output and the gradients of x, D
    and the norm's scale within test_torch_mamba.py's 1e-5, here of the
    largest |value| (dD, a sum over 64 rows, reaches 21)."""
    import _mamba_jax_ref as jref
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import mamba2 as mb
    params, a = jref.load()
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype="float32", ssd_impl="pallas")
    p = params_from_numpy(params, "cpu")
    x = torch.from_numpy(a["x"]).requires_grad_()
    leaves = [x, p["D"].requires_grad_(), p["norm"]["scale"].requires_grad_()]
    out = mb.mamba_apply(p, x, cfg)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(a["cotangent"]))
    for got, name in zip((out, *grads), ("out", "dx", "dD", "dscale")):
        want = torch.from_numpy(a[name])
        err = (got.detach() - want).abs().max() / want.abs().max()
        assert float(err) < 1e-5, name
