"""Port parity: the SSD kernel's plain versions and wrappers against the
JAX reference on the CPU.

Inputs are made with numpy from a fixed seed and handed to both packages.
The JAX SSD kernel runs in Pallas interpret mode, as its own tests run it;
the port's wrapper takes its plain version for CPU tensors. The CUDA
kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jref
from repro.kernels.ssd.kernel import ssd_flat as jssd_flat
from repro.models import api as japi
from repro.models import mamba2 as jmb
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref
from repro_torch.models import mamba2 as mb
from repro_torch.models import transformer as tfm

F32_TOL, BF16_TOL = 5e-5, 5e-2   # tests/test_kernels.py: kernel vs oracle
LAYOUT_TOL = 2e-5                # tests/test_kernels.py: model layout

# the cases of tests/test_kernels.py::SSD_CASES: (BH, S, P, N, Q, bf16)
SSD_CASES = [
    (3, 256, 64, 32, 64, False),
    (2, 128, 32, 128, 128, False),
    (4, 64, 16, 16, 32, False),
    (2, 128, 64, 64, 64, True),
    (1, 512, 32, 32, 128, False),
]


def _inputs(seed, BH, S, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, S)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(BH) * 0.3).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((BH, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((BH, S, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrays, bf16):
    """The inputs for JAX and for the port: x, Bm, Cm in the working
    dtype, dt and A in f32."""
    x, dt, A, Bm, Cm = arrays
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    j = (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm).astype(jd), jnp.asarray(Cm).astype(jd))
    t = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(td),
         torch.from_numpy(Cm).to(td))
    return j, t


def _err(t, j):
    return float(np.abs(t.float().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


def _check(got, want, tol):
    (y, h), (jy, jh) = got, want
    assert y.shape == jy.shape and h.shape == jh.shape
    assert h.dtype == torch.float32
    assert _err(y, jy) < tol and _err(h, jh) < tol


@pytest.mark.parametrize("impl", ["scan", "chunked", "flat"])
@pytest.mark.parametrize("BH,S,P,N,Q,bf16", SSD_CASES)
def test_plain_versions_and_wrapper_match_reference(impl, BH, S, P, N, Q,
                                                    bf16):
    j, t = _both(_inputs(0, BH, S, P, N), bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    if impl == "scan":
        got, want = ref.ssd_scan_ref(*t), jref.ssd_scan_ref(*j)
    elif impl == "chunked":
        got, want = (ref.ssd_chunked_ref(*t, chunk=Q),
                     jref.ssd_chunked_ref(*j, chunk=Q))
    else:
        before = sk.launches
        got = sk.ssd_flat(*t, chunk=Q)
        assert sk.launches == before     # CPU tensors take the plain version
        want = jssd_flat(*j, chunk=Q, interpret=True)
    assert got[0].dtype == t[0].dtype
    _check(got, want, tol)


@pytest.mark.parametrize("S,chunk,Q", [(200, 64, 8), (100, 256, 100),
                                       (129, 64, 1), (24, 256, 24),
                                       (8192, 256, 256)])
def test_chunk_rule_matches_reference_kernel(S, chunk, Q):
    assert sk.chunk_len(S, chunk) == Q
    if S > 256:
        return
    j, t = _both(_inputs(1, 2, S, 16, 16), False)
    _check(sk.ssd_flat(*t, chunk=chunk),
           jssd_flat(*j, chunk=chunk, interpret=True), F32_TOL)


def test_plain_version_keeps_large_decays_finite():
    """A down to -16 and dt near 1: exp(cum_i - cum_j) overflows above the
    diagonal, and the select must keep the inf out of y."""
    x, dt, _, Bm, Cm = _inputs(2, 2, 256, 16, 16)
    A = np.full((2,), -16.0, np.float32)
    dt = dt + 1.0
    j, t = _both((x, dt, A, Bm, Cm), False)
    got = ref.ssd_chunked_ref(*t, chunk=256)
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    _check(got, jref.ssd_scan_ref(*j), F32_TOL)


def test_model_layout_ssd_matches_reference():
    B_, S, H, P, N = 2, 128, 3, 32, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B_, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, S, H)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B_, S, H, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B_, S, H, N))).astype(np.float32)
    arrays = (x, dt, A, Bm, Cm)
    want = jssd_ops.ssd(*(jnp.asarray(a) for a in arrays), 64)
    got = ssd_ops.ssd(*(torch.from_numpy(a) for a in arrays), 64)
    assert got[0].shape == (B_, S, H, P) and got[1].shape == (B_, H, N, P)
    assert _err(got[0], want[0]) < LAYOUT_TOL
    assert _err(got[1], want[1]) < LAYOUT_TOL


@pytest.mark.parametrize("G", [1, 2])
def test_model_layout_grouped_strided_matches_reference(G):
    """The kernel's model-layout entry: x, B and C as strided views of one
    packed projection (as mamba2 hands them over), B and C per group,
    against the reference kernel on the broadcast per-head B and C."""
    B_, S, H, P, N = 2, 128, 4, 32, 16
    rng = np.random.default_rng(10 + G)
    packed = rng.standard_normal((B_, S, H * P + 2 * G * N + 8)).astype(
        np.float32)
    packed[..., H * P:] *= 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B_, S, H)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)

    def split(a):
        return (a[..., :H * P].reshape(B_, S, H, P),
                a[..., H * P:H * P + G * N].reshape(B_, S, G, N),
                a[..., H * P + G * N:H * P + 2 * G * N].reshape(B_, S, G, N))

    x, Bg, Cg = split(packed)
    R = H // G
    want = jssd_ops.ssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                        jnp.asarray(np.repeat(Bg, R, axis=2)),
                        jnp.asarray(np.repeat(Cg, R, axis=2)), 64)
    tx, tB, tC = split(torch.from_numpy(packed))
    assert not (tx.is_contiguous() or tB.is_contiguous())
    before = sk.launches
    got = ssd_ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                      64)
    assert sk.launches == before         # CPU tensors take the plain version
    assert got[0].shape == (B_, S, H, P) and got[1].shape == (B_, H, N, P)
    assert _err(got[0], want[0]) < LAYOUT_TOL
    assert _err(got[1], want[1]) < LAYOUT_TOL


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba_apply_kernel_path_matches_reference(ngroups, monkeypatch):
    """Reduced mamba2 with ssd_impl="pallas" against the reference's
    mamba_apply; the kernel entry gets B and C per group and x as views of
    the block's projection, never a broadcast or a copy."""
    def cfg_of(reg):
        cfg = reg.reduce_for_smoke(reg.get("mamba2-2.7b"))
        return cfg.replace(dtype="float32", ssd_impl="pallas",
                           ssm=dataclasses.replace(cfg.ssm,
                                                   ngroups=ngroups))
    jcfg, cfg = cfg_of(jregistry), cfg_of(registry)
    jparams = japi.init(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    jp = jax.tree.map(lambda t: t[0], jparams["stack"][0])["mamba"]
    tp = tfm._index(params["stack"][0], 0)["mamba"]
    x = np.random.default_rng(16).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)

    seen = []
    grouped = sk.ssd_grouped

    def spy(xh, dt, A, Bm, Cm, **kw):
        seen.append((xh, Bm, Cm))
        return grouped(xh, dt, A, Bm, Cm, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_grouped", spy)
    out, (_, h) = mb.mamba_apply(tp, torch.from_numpy(x), cfg,
                                 return_state=True)
    jout, (_, jh) = jmb.mamba_apply(jp, jnp.asarray(x), jcfg,
                                    return_state=True)
    assert _err(out, jout) < LAYOUT_TOL and _err(h, jh) < LAYOUT_TOL
    (xh, Bm, Cm), = seen
    _, H, _ = mb.mamba_dims(cfg)
    assert Bm.shape == Cm.shape == (2, 32, ngroups, cfg.ssm.d_state)
    assert xh.shape == (2, 32, H, cfg.ssm.headdim)
    # views of one projection buffer: nothing was materialised for them
    assert (xh.untyped_storage().data_ptr()
            == Bm.untyped_storage().data_ptr()
            == Cm.untyped_storage().data_ptr())
    assert not (xh.is_contiguous() or Bm.is_contiguous())


@pytest.mark.parametrize("BH,nc,Q,P,N", [
    (320, 32, 256, 64, 128),      # mamba2-2.7b prefill, 8192 tokens
    (320, 8191, 1, 64, 128),      # an odd prompt: Q = 1
    (320, 4095, 2, 64, 128),      # S = 2 mod 4: Q = 2
    (320, 1025, 8, 64, 128),      # S = 8200: Q = 8
    (4, 3, 100, 16, 16),          # a short prompt
    (100000, 4, 256, 128, 128),   # many heads at the widest state
])
def test_scratch_windows_stay_within_budget(monkeypatch, BH, nc, Q, P, N):
    """The bf16 path's scratch no longer grows with the chunks (the chained
    pass has no windows): two f32 (P, N) state slots and a flag for each
    (batch, head) and one ticket counter, BH * (2 N P 4 + 4) + 4 bytes
    whatever nc is; the meta path allocates exactly that."""
    want = BH * (2 * N * P * 4 + 4) + 4
    assert sk.FLAG_BYTES == 4 and sk.scratch_bytes(BH, P, N) == want
    seen = []

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    real = sk.scratch
    monkeypatch.setattr(sk, "scratch", spy)
    S = nc * Q
    meta = dict(device="meta")
    x = torch.empty((1, S, BH, P), dtype=torch.bfloat16, **meta)
    Bm = torch.empty((1, S, 1, N), dtype=torch.bfloat16, **meta)
    dt = torch.empty((1, S, BH), **meta)
    A = torch.empty((BH,), **meta)
    y, hT = sk.ssd_grouped(x, dt, A, Bm, Bm, chunk=Q)
    assert y.shape == x.shape and hT.shape == (1, BH, N, P)
    (slots, flags), = seen
    assert slots.device.type == flags.device.type == "meta"
    assert slots.shape == (BH, 2, P, N) and flags.shape == (BH + 1,)
    assert (slots.numel() * slots.element_size()
            + flags.numel() * flags.element_size()) == want


def test_kernel_path_refuses_initial_state_and_bad_inputs():
    _, t = _both(_inputs(4, 2, 32, 16, 16), False)
    x, dt, A, Bm, Cm = t
    h0 = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="h0 must be None"):
        ssd_ops.ssd(x[None].transpose(1, 2), dt[None].transpose(1, 2), A,
                    Bm[None].transpose(1, 2), Cm[None].transpose(1, 2),
                    h0=h0)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        sk.ssd_flat(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        sk.ssd_flat(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="shapes disagree"):
        sk.ssd_flat(x, dt[:, :-1], A, Bm, Cm)
