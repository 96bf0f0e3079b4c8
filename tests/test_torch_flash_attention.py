"""Port parity: the flash-attention kernel's plain version and wrappers,
and the torch attention cores, against the JAX reference on the CPU.

Inputs are made with numpy from a fixed seed and handed to both packages.
The JAX flash kernel runs in Pallas interpret mode, as its own tests run
it. The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.kernel import \
    flash_attention_flat as jflash_flat
from repro.models import common as jcm
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import common as cm

F32_TOL, BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py: kernel vs oracle


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _err(t, j):
    return float(np.abs(t.float().cpu().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


# (BHkv, R, Sq, Skv, D, causal, window, softcap, q_offset, bf16)
FLAT_CASES = [
    # the cases of tests/test_kernels.py::FA_CASES
    (4, 1, 256, 256, 64, True, 0, 0.0, 0, False),
    (2, 1, 128, 128, 128, True, 64, 0.0, 0, False),
    (2, 1, 256, 256, 64, True, 0, 50.0, 0, False),
    (3, 1, 128, 128, 32, False, 0, 0.0, 0, False),
    (2, 1, 512, 512, 64, True, 0, 0.0, 0, False),
    (2, 1, 128, 128, 64, True, 0, 0.0, 0, True),
    (1, 1, 64, 64, 256, True, 0, 0.0, 0, False),
    # GQA, query offset, ragged lengths, the serving features together
    (2, 3, 128, 128, 64, True, 0, 0.0, 0, False),
    (2, 2, 64, 192, 32, True, 0, 0.0, 128, False),
    (2, 2, 200, 200, 16, True, 48, 50.0, 0, False),
    (2, 2, 96, 96, 256, True, 32, 50.0, 0, True),
]


@pytest.mark.parametrize("BHkv,R,Sq,Skv,D,causal,window,cap,q_offset,bf16",
                         FLAT_CASES)
def test_attention_ref_vs_jax_flash_kernel(BHkv, R, Sq, Skv, D, causal,
                                           window, cap, q_offset, bf16):
    q, k, v = _inputs(0, (BHkv * R, Sq, D), (BHkv, Skv, D), (BHkv, Skv, D))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    want = jflash_flat(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                       interpret=True, **kw)
    got = attention_ref(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt), **kw)
    assert got.dtype == tdt and got.shape == (BHkv * R, Sq, D)
    assert _err(got, want) < (BF16_TOL if bf16 else F32_TOL)


def test_flat_wrapper_on_cpu_is_the_plain_version():
    q, k, v = _inputs(1, (6, 40, 32), (2, 40, 32), (2, 40, 32))
    kw = dict(causal=True, window=16, softcap=50.0, q_offset=0, kv_repeat=3)
    before = fk.launches
    got = fk.flash_attention_flat(_torch(q), _torch(k), _torch(v), **kw)
    want = attention_ref(_torch(q), _torch(k), _torch(v), **kw)
    assert torch.equal(got, want)
    assert fk.launches == before   # the plain version is not a launch


@pytest.mark.parametrize("bad,exc", [
    ("shape", ValueError), ("repeat", ValueError), ("dtype", TypeError)])
def test_flat_wrapper_rejects_bad_inputs(bad, exc):
    q, k, v = [_torch(a) for a in _inputs(2, (4, 8, 16), (2, 8, 16),
                                          (2, 8, 16))]
    kw = dict(kv_repeat=2)
    if bad == "shape":
        v = v[:, :4]
    elif bad == "repeat":
        kw["kv_repeat"] = 3
    else:
        q = q.double()
    with pytest.raises(exc):
        fk.flash_attention_flat(q, k, v, **kw)


@pytest.mark.parametrize("which,offset,refused", [
    ("q", 1, True), ("k", 1, True), ("v", 1, True), ("q", 8, False)])
def test_flat_wrapper_refuses_a_misaligned_bf16_view(which, offset,
                                                      refused):
    """The bf16 kernels read q, k, v in 16-byte pieces (TMA boxes,
    cp.async): a meta view one element (2 bytes) past an aligned base is
    refused before any launch, as it is on the card; eight elements (16
    bytes) pass."""
    shapes = {"q": (4, 64, 64), "k": (2, 64, 64), "v": (2, 64, 64)}
    t = {}
    for name, shape in shapes.items():
        off = offset if name == which else 0
        flat = torch.empty(off + math.prod(shape), dtype=torch.bfloat16,
                           device="meta")
        t[name] = flat[off:].view(shape)
    assert t[which].storage_offset() == offset
    before = fk.launches
    if refused:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fk.flash_attention_flat(t["q"], t["k"], t["v"], kv_repeat=2)
    else:
        out = fk.flash_attention_flat(t["q"], t["k"], t["v"], kv_repeat=2)
        assert (out.shape, out.device.type) == (t["q"].shape, "meta")
    assert fk.launches == before


@pytest.mark.parametrize("causal,window,cap,q_offset", [
    (True, 0, 0.0, 0), (True, 24, 50.0, 0), (False, 0, 0.0, 0),
    (True, 0, 0.0, 16)])
def test_grouped_flash_attention_vs_jax(causal, window, cap, q_offset):
    q, k, v = _inputs(3, (2, 64, 2, 3, 32), (2, 64 + q_offset, 2, 32),
                      (2, 64 + q_offset, 2, 32))
    want = jfa_ops.flash_attention(_jax(q), _jax(k), _jax(v), causal, window,
                                   cap, q_offset)
    got = fa_ops.flash_attention(_torch(q), _torch(k), _torch(v), causal,
                                 window, cap, q_offset)
    assert got.shape == (2, 64, 2, 3, 32)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("B", [1, 2])
def test_grouped_flash_attention_hands_the_kernel_contiguous_heads(
        B, monkeypatch):
    """With B = 1 the flattening reshapes are strided views; the kernel
    takes contiguous flat heads only, so the grouped entry makes them so
    (batch-1 serving through the kernel raised before)."""
    q, k, v = _inputs(5, (B, 40, 2, 2, 16), (B, 40, 2, 16), (B, 40, 2, 16))
    seen = []
    flat = fa_ops.flash_attention_flat

    def spy(qf, kf, vf, **kw):
        seen.append((qf, kf, vf))
        return flat(qf, kf, vf, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_flat", spy)
    got = fa_ops.flash_attention(_torch(q), _torch(k), _torch(v), True, 0,
                                 50.0, 0)
    want = jfa_ops.flash_attention(_jax(q), _jax(k), _jax(v), True, 0, 50.0,
                                   0)
    (qf, kf, vf), = seen
    assert qf.is_contiguous() and kf.is_contiguous() and vf.is_contiguous()
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("causal,window,cap,q_offset,chunks", [
    (True, 0, 0.0, 0, (16, 16)), (True, 20, 50.0, 0, (16, 32)),
    (False, 0, 50.0, 0, (32, 16)), (True, 0, 0.0, 8, (24, 20))])
def test_chunked_attention_vs_jax(causal, window, cap, q_offset, chunks):
    q, k, v = _inputs(4, (2, 48, 2, 2, 16), (2, 48 + q_offset, 2, 16),
                      (2, 48 + q_offset, 2, 16))
    want = jcm.chunked_attention(_jax(q), _jax(k), _jax(v), causal, window,
                                 cap, q_offset, *chunks)
    got = cm.chunked_attention(_torch(q), _torch(k), _torch(v), causal,
                               window, cap, q_offset, *chunks)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("causal,window,cap,kv_valid_len", [
    (True, 0, 0.0, None), (True, 12, 50.0, None), (False, 0, 0.0, 30),
    (False, 6, 50.0, 30)])
def test_naive_attention_vs_jax(causal, window, cap, kv_valid_len):
    Sq = 40 if kv_valid_len is None else 1
    q_offset = 0 if kv_valid_len is None else kv_valid_len - 1
    q, k, v = _inputs(5, (2, Sq, 2, 2, 16), (2, 40, 2, 16), (2, 40, 2, 16))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_valid_len=kv_valid_len)
    want = jcm.naive_attention(_jax(q), _jax(k), _jax(v), **kw)
    got = cm.naive_attention(_torch(q), _torch(k), _torch(v), **kw)
    assert _err(got, want) < 1e-5
