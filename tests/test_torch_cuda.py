"""The port's hand-written CUDA kernels on the card: their builds, each
against its plain PyTorch version at small cases and at the models'
shapes, the reduced models served and trained through them, and the
LeNet CPSL round, trainer and experiment fleets on the card.

This file and ``tests/test_torch_cuda_models.py`` (the models at full
width) and ``tests/test_torch_cuda_system.py`` (simulator, deployment
runtime, dry run, analysis) are the port's on-card check suite. Every test
is marked ``requires_cuda`` and skips on a host without a card (the
kernels have no CPU mode). The files import neither JAX nor the reference,
so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda*.py
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import streams, telemetry
from repro_torch.configs import registry
from repro_torch.configs.base import LayerSpec
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.serving.engine import ServeEngine

F32_TOL, BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py: kernel vs oracle
SSD_F32_TOL, SSD_BF16_TOL = 5e-5, 5e-2   # tests/test_kernels.py: SSD
LOGITS_TOL = 0.15                # tests/test_kernels.py: bf16 model path

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def launched():
    """The hand-written kernels' launches during the test, by name."""
    with telemetry.LaunchCounter() as n:
        yield n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the blocks earlier tests cached, which would fragment a full-width
    # model's tens of GB
    torch.cuda.empty_cache()
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, device=gen.device, generator=gen).to(dtype)


def _ptxas_entries(text: str) -> dict:
    """{mangled kernel: {registers, spill_bytes}} from an nvcc
    ``-Xptxas=-v`` log."""
    usage, fn = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            usage[fn] = {"spill_bytes": int(re.search(
                r"(\d+) bytes spill stores", line).group(1))}
        elif fn and "Used" in line and "registers" in line:
            usage.setdefault(fn, {})["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
            fn = None
    return usage


# the bf16 tensor-core kernels of each source: the entries that must each
# be built once, and the kernels in which ptxas may serialise no wgmma
BF16_BUILDS = {
    "flash_attention": (
        [("attn_ws_kernel" if D >= 64 else "attn_bf16_kernel") + f"ILi{D}E"
         for D in fk.HEAD_DIMS], ("attn_ws_kernel", "attn_bf16_kernel")),
    "ssd": ([f"ssd_chain_kernelILi{N}ELi{P}E" for N in sk.STATE_DIMS
             for P in sk.STATE_DIMS], ("",)),
}


@pytest.mark.parametrize("source", BF16_BUILDS)
def test_bf16_kernels_build_without_serialised_wgmma_or_spills(cuda,
                                                               source):
    """ptxas prints "wgmma.mma_async instructions are serialized" when an
    accumulator is touched between issue and wait, a wgmma sits under a
    per-iteration branch, or registers run short: that kernel then runs
    each wgmma alone. K1's bf16 kernel of each head dim and K2's chained
    kernel of each (N, P) are built once each, with no spill."""
    from repro_torch.kernels import _build
    _build.build([source])
    text = _build.build_log(source)
    assert text, f"no ptxas log for csrc/{source}.cu"
    names, guarded = BF16_BUILDS[source]
    serial = {m.group(1) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized.*?'(\w+)'", text)}
    assert not [f for f in serial if any(g in f for g in guarded)], serial
    usage = _ptxas_entries(text)
    for name in names:
        found = [f for f in usage if name in f]
        assert len(found) == 1, (name, found)
        assert usage[found[0]].get("spill_bytes", 0) == 0, \
            (name, usage[found[0]])


# (BHkv, R, Sq, Skv, D, causal, window, softcap, q_offset)
FLAT_CASES = [
    (4, 1, 256, 256, 64, True, 0, 0.0, 0),
    (2, 1, 128, 128, 128, True, 64, 0.0, 0),
    (3, 1, 128, 128, 32, False, 0, 0.0, 0),
    (1, 1, 64, 64, 256, True, 0, 50.0, 0),
    (2, 3, 128, 128, 64, True, 0, 0.0, 0),
    (2, 2, 64, 192, 32, True, 0, 0.0, 128),
    (2, 2, 200, 200, 16, True, 48, 50.0, 0),
    (2, 2, 96, 96, 256, True, 32, 50.0, 0),
    (1, 2, 5, 77, 128, True, 16, 0.0, 72),
    # GQA at R = 4 (phi3.5-moe, jamba); q_offset > 0 with a window
    (2, 4, 255, 255, 128, True, 0, 0.0, 0),
    (1, 4, 100, 300, 128, True, 50, 0.0, 200),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BHkv,R,Sq,Skv,D,causal,window,cap,q_offset",
                         FLAT_CASES)
def test_flash_kernel_vs_plain(launched, cuda, dtype, BHkv, R, Sq, Skv, D,
                               causal, window, cap, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, BHkv * R, Sq, D, dtype=dtype)
    k = _randn(gen, BHkv, Skv, D, dtype=dtype)
    v = _randn(gen, BHkv, Skv, D, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    before = launched["flash_attention"]
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launched["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err < (F32_TOL if dtype == torch.float32 else BF16_TOL)


# bf16 cases at the edges of the tensor-core kernels' tiles (64 query rows
# a warpgroup, 128 or 192 a block; 80 to 128 keys a tile at D >= 64): Sq
# and Skv off the tile grid, a window edge inside a tile, q_offset > 0, a
# non-causal ragged Skv, Skv shorter than one key tile
# (BHkv, R, Sq, Skv, D, causal, window, softcap, q_offset)
TILE_EDGE_CASES = [
    (2, 2, 130, 130, 256, True, 40, 50.0, 0),
    (2, 1, 77, 203, 128, True, 0, 0.0, 126),
    (1, 2, 100, 100, 64, True, 33, 0.0, 0),
    (2, 1, 65, 300, 256, True, 100, 50.0, 235),
    (2, 1, 70, 150, 32, False, 0, 0.0, 0),
    (1, 1, 1, 97, 16, True, 0, 50.0, 96),
    (2, 1, 20, 30, 128, True, 0, 0.0, 10),
    (2, 4, 64, 40, 64, False, 0, 0.0, 0),
    (2, 1, 100, 200, 256, True, 30, 50.0, 100),
]


@pytest.mark.parametrize("BHkv,R,Sq,Skv,D,causal,window,cap,q_offset",
                         TILE_EDGE_CASES)
def test_flash_kernel_bf16_tile_edges(cuda, BHkv, R, Sq, Skv, D, causal,
                                      window, cap, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, BHkv * R, Sq, D, dtype=torch.bfloat16)
    k = _randn(gen, BHkv, Skv, D, dtype=torch.bfloat16)
    v = _randn(gen, BHkv, Skv, D, dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() < BF16_TOL


# head dim 192 (deepseek-v2-lite's MLA prefill: qk_nope 128 + qk_rope 64),
# three 128-byte swizzle atoms a row: causal, windowed, GQA, softcap, off
# the tile grid, a window with softcap and q_offset > 0, Skv shorter than
# one key tile; (BHkv, R, Sq, Skv, causal, window, softcap, q_offset)
D192_CASES = [
    (4, 1, 256, 256, True, 0, 0.0, 0),
    (2, 1, 200, 200, True, 64, 0.0, 0),
    (2, 2, 130, 130, True, 40, 50.0, 0),
    (2, 1, 77, 203, True, 0, 0.0, 126),
    (3, 1, 96, 160, False, 0, 0.0, 0),
    (2, 1, 129, 129, True, 64, 50.0, 7),
    (1, 1, 65, 100, True, 32, 50.0, 35),
    (2, 1, 40, 30, False, 0, 0.0, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BHkv,R,Sq,Skv,causal,window,cap,q_offset",
                         D192_CASES)
def test_flash_kernel_d192_vs_plain(launched, cuda, dtype, BHkv, R, Sq, Skv,
                                    causal, window, cap, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(gen, BHkv * R, Sq, 192, dtype=dtype)
    k = _randn(gen, BHkv, Skv, 192, dtype=dtype)
    v = _randn(gen, BHkv, Skv, 192, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    before = launched["flash_attention"]
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launched["flash_attention"] == before + 1
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err < (F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("D", [64, 128, 192])
@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 127, 128, 129, 255])
def test_flash_kernel_bf16_query_edges(cuda, Sq, D):
    """Sq around the 64-row warpgroup and the 128- or 192-row block:
    causal self-attention, GQA at R = 4 where D = 128."""
    gen = torch.Generator(device=cuda).manual_seed(Sq)
    R = 4 if D == 128 else 1
    q = _randn(gen, 2 * R, Sq, D, dtype=torch.bfloat16)
    k = _randn(gen, 2, Sq, D, dtype=torch.bfloat16)
    v = _randn(gen, 2, Sq, D, dtype=torch.bfloat16)
    kw = dict(causal=True, window=0, softcap=0.0, q_offset=0, kv_repeat=R)
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() < BF16_TOL


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
def test_flash_kernel_bf16_window_softcap_ragged(launched, cuda, D):
    """Each head dim's bf16 kernel (one-warpgroup below 64, warp-specialised
    from 64) against the plain version: a window edge, softcap, q_offset
    and a ragged Sq and Skv in one call."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    q = _randn(gen, 4, 150, D, dtype=torch.bfloat16)
    k = _randn(gen, 2, 170, D, dtype=torch.bfloat16)
    v = _randn(gen, 2, 170, D, dtype=torch.bfloat16)
    kw = dict(causal=True, window=90, softcap=50.0, q_offset=20,
              kv_repeat=2)
    before = launched["flash_attention"]
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launched["flash_attention"] == before + 1
    want = attention_ref(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() < BF16_TOL


# bf16 at the models' prefill shapes: (BHkv, R, Sq, Skv, D, causal, window,
# softcap): gemma2-2b's local and global layers (batch 4, 5120 tokens),
# deepseek-v2-lite's MLA (batch 4, 4096), phi3.5-moe's and jamba's GQA,
# whisper-small's encoder and cross-attention (16 clips of 12 heads)
MODEL_FLASH_CASES = [
    (16, 2, 5120, 5120, 256, True, 4096, 50.0),
    (16, 2, 5120, 5120, 256, True, 0, 50.0),
    (64, 1, 4096, 4096, 192, True, 0, 0.0),
    (32, 4, 4096, 4096, 128, True, 0, 0.0),
    (192, 1, 1500, 1500, 64, False, 0, 0.0),
    (192, 1, 64, 1500, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("BHkv,R,Sq,Skv,D,causal,window,cap",
                         MODEL_FLASH_CASES)
def test_flash_kernel_at_model_shapes(cuda, BHkv, R, Sq, Skv, D, causal,
                                      window, cap):
    """Without a softcap, within one bf16 ulp of the largest output as
    well: ``scaled_dot_product_attention`` computes the same function
    there, and non-causal outputs over many keys are small (~0.04)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, BHkv * R, Sq, D, dtype=torch.bfloat16)
    k = _randn(gen, BHkv, Skv, D, dtype=torch.bfloat16)
    v = _randn(gen, BHkv, Skv, D, dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=0,
              kv_repeat=R)
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    err, tol = _flash_err(got, attention_ref(q, k, v, **kw), cap)
    assert err <= tol, (err, tol)


def _flash_err(got, want, cap: float):
    """K1's bf16 output against its plain version at a model's shape: (max
    abs error, its limit)."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, (BF16_TOL if cap else
                 min(BF16_TOL, 2.0 ** -7 * want.abs().max().item()))


def test_flash_kernel_refuses_misaligned_bf16(launched, cuda):
    """A bf16 view one element past an aligned base: the TMA maps need
    16-byte aligned bases, so the wrapper raises before any launch."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = _randn(gen, 1 + 2 * 64 * 64, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 64)
    k = _randn(gen, 2, 64, 64, dtype=torch.bfloat16)
    before = launched["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fk.flash_attention_flat(q, k, k)
    assert launched["flash_attention"] == before


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(gen, 2, 16, 48) for _ in range(3))
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_flat(q, k, v)


def test_grouped_flash_attention_vs_naive(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, 2, 130, 2, 3, 64)
    k, v = _randn(gen, 2, 130, 2, 64), _randn(gen, 2, 130, 2, 64)
    got = fa_ops.flash_attention(q, k, v, True, 40, 50.0, 0)
    want = cm.naive_attention(q, k, v, causal=True, window=40, softcap=50.0)
    assert (got - want).abs().max().item() < 1e-5


def test_reduced_gemma2_serves_through_the_kernel(launched, cuda):
    cfg = registry.reduce_for_smoke(registry.get("gemma2-2b"))
    cfg = cfg.replace(dtype="float32", attn_impl="pallas",
                      pattern=(LayerSpec("attn", "dense", window=8),
                               cfg.pattern[1]))
    params = api.init(streams.model_generator(0, cuda), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    eng = ServeEngine(cfg, params, cap=48, device=cuda)
    naive = ServeEngine(cfg.replace(attn_impl="naive"), params, cap=48,
                        device=cuda)
    before = launched["flash_attention"]
    out = eng.generate({"tokens": toks}, steps=8)
    assert launched["flash_attention"] == before + cfg.n_layers
    assert torch.equal(out, naive.generate({"tokens": toks}, steps=8))
    err = (eng.prefill({"tokens": toks})[0]
           - naive.prefill({"tokens": toks})[0]).abs().max().item()
    assert err < 1e-4


# (BH, S, P, N, chunk, dtype, large |A| dt)
SSD_CASES = [
    # the cases of tests/test_kernels.py::SSD_CASES
    (3, 256, 64, 32, 64, torch.float32, False),
    (2, 128, 32, 128, 128, torch.float32, False),
    (4, 64, 16, 16, 32, torch.float32, False),
    (2, 128, 64, 64, 64, torch.bfloat16, False),
    (1, 512, 32, 32, 128, torch.float32, False),
    # mamba2-2.7b's N, P and chunk at small BH, in both dtypes
    (2, 512, 64, 128, 256, torch.float32, False),
    (2, 512, 64, 128, 256, torch.bfloat16, False),
    # ragged S: the chunk halves to 8; S < chunk (Q = 100, not a multiple
    # of the 64-row tile); odd S > chunk (Q = 1); S = 2 mod 4 (Q = 2)
    (2, 200, 32, 32, 64, torch.float32, False),
    (2, 100, 64, 128, 256, torch.bfloat16, False),
    (1, 129, 16, 16, 64, torch.float32, False),
    (2, 129, 64, 128, 256, torch.bfloat16, False),
    (2, 130, 64, 128, 256, torch.bfloat16, False),
    # exp(cum_i - cum_j) overflows above the diagonal: no NaN may leak
    (2, 256, 64, 128, 256, torch.float32, True),
    (2, 256, 64, 128, 256, torch.bfloat16, True),
    # jamba's N = 16 at its P = 64: its chunk 256 in bf16 (the serving
    # dtype), chunks of 64 in f32 (the reduced models' path)
    (2, 512, 64, 16, 256, torch.bfloat16, False),
    (2, 512, 64, 16, 64, torch.float32, False),
    # the bf16 chain's edges: one item a head (nc = 1), two (the slots'
    # first reuse), and BH below the SM count and not a divisor of it
    (5, 256, 64, 128, 256, torch.bfloat16, False),
    (3, 512, 64, 128, 256, torch.bfloat16, False),
    (7, 768, 32, 64, 256, torch.bfloat16, False),
    # P = 128: items of 128 rows, two to a chunk of 256
    (2, 512, 128, 128, 256, torch.bfloat16, False),
    # Q = 1 over more than one item of 256 chunks; Q = 100 over three
    (3, 1023, 64, 128, 256, torch.bfloat16, False),
    (2, 300, 64, 128, 100, torch.bfloat16, False),
    # mamba2-2.7b's prefill as 4 x 80 flat heads of 8192 tokens
    (320, 8192, 64, 128, 256, torch.bfloat16, False),
]


def _ssd_inputs(gen, BH, S, P, N, dtype, big_decay):
    """tests/test_kernels.py's inputs, with B and C scaled by
    0.5 * min(1, 32 / N) so that |y| stays below ~8 at any N: the absolute
    limits then measure the kernel (5e-5 is a few f32 ulps; 5e-2 is under
    one bf16 ulp only below 8)."""
    x = _randn(gen, BH, S, P, dtype=dtype)
    shift = 1.0 if big_decay else -1.0
    dt = F.softplus(_randn(gen, BH, S) + shift)
    A = (torch.full((BH,), -16.0, device=gen.device) if big_decay
         else -torch.exp(_randn(gen, BH) * 0.3))
    scale = 0.5 * min(1.0, 32 / N)
    Bm = (_randn(gen, BH, S, N) * scale).to(dtype)
    Cm = (_randn(gen, BH, S, N) * scale).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("BH,S,P,N,chunk,dtype,big_decay", SSD_CASES)
def test_ssd_kernel_vs_plain(launched, cuda, BH, S, P, N, chunk, dtype,
                             big_decay):
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = _ssd_inputs(gen, BH, S, P, N, dtype, big_decay)
    before = launched["ssd"]
    y, hT = sk.ssd_flat(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert launched["ssd"] == before + 1
    assert y.dtype == dtype and y.shape == (BH, S, P)
    assert hT.dtype == torch.float32 and hT.shape == (BH, N, P)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(hT).all())
    tol = SSD_F32_TOL if dtype == torch.float32 else SSD_BF16_TOL
    plains = [ssd_chunked_ref(*args, chunk=sk.chunk_len(S, chunk))]
    if S <= 512:
        plains.append(ssd_scan_ref(*args))
    for y_p, h_p in plains:
        assert (y.float() - y_p.float()).abs().max().item() < tol
        assert (hT - h_p).abs().max().item() < tol


def _packed_model_layout(gen, B_, S, H, G, P, N, dtype, bc_scale=None):
    """x, B and C as the mamba2 block hands them to the kernel: strided
    views into one packed (B, S, H*P + 2*G*N) projection, B and C per
    group; dt (B, S, H) and A (H,). B and C scaled as ``_ssd_inputs``
    unless ``bc_scale`` is given."""
    packed = _randn(gen, B_, S, H * P + 2 * G * N)
    packed[..., H * P:] *= (0.5 * min(1.0, 32 / N) if bc_scale is None
                            else bc_scale)
    packed = packed.to(dtype)
    x = packed[..., :H * P].reshape(B_, S, H, P)
    Bm = packed[..., H * P:H * P + G * N].reshape(B_, S, G, N)
    Cm = packed[..., H * P + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(_randn(gen, B_, S, H) - 1.0)
    A = -torch.exp(_randn(gen, H) * 0.3)
    return x, dt, A, Bm, Cm


# (B, S, H, G, P, N, chunk, dtype): one group and two over 8 heads, the
# serving N/P/chunk, a ragged S (Q = 200: query tiles of 64, 64, 64, 8),
# and the float32 path
GROUPED_CASES = [
    (2, 512, 8, 1, 64, 128, 256, torch.bfloat16),
    (2, 512, 8, 2, 64, 128, 256, torch.bfloat16),
    (2, 200, 8, 2, 32, 64, 256, torch.bfloat16),
    (1, 256, 8, 2, 32, 32, 64, torch.float32),
    (2, 512, 8, 1, 64, 16, 256, torch.bfloat16),    # jamba's N and P
    # the chain's edges: heads per group 1 and 8, nc = 1 and 2, Q = 1
    # (an odd S) and Q = 100, B * H below the SM count
    (1, 512, 8, 8, 64, 128, 256, torch.bfloat16),
    (3, 256, 16, 2, 64, 128, 256, torch.bfloat16),
    (2, 511, 5, 1, 64, 128, 256, torch.bfloat16),
    (3, 300, 4, 2, 64, 128, 100, torch.bfloat16),
]


@pytest.mark.parametrize("B_,S,H,G,P,N,chunk,dtype", GROUPED_CASES)
def test_ssd_grouped_strided_vs_plain(launched, cuda, B_, S, H, G, P, N, chunk,
                                      dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, dt, A, Bm, Cm = _packed_model_layout(gen, B_, S, H, G, P, N, dtype)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    before = launched["ssd"]
    y, hT = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert launched["ssd"] == before + 1
    assert y.shape == (B_, S, H, P) and y.dtype == dtype
    assert hT.shape == (B_, H, N, P) and hT.dtype == torch.float32
    # the plain version on the broadcast, flat tensors
    R = H // G
    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(B_ * H, S, t.shape[-1])
    args = (flat(x), dt.permute(0, 2, 1).reshape(B_ * H, S), A.repeat(B_),
            flat(Bm.repeat_interleave(R, dim=2)),
            flat(Cm.repeat_interleave(R, dim=2)))
    y_p, h_p = ssd_chunked_ref(*args, chunk=sk.chunk_len(S, chunk))
    tol = SSD_F32_TOL if dtype == torch.float32 else SSD_BF16_TOL
    assert (flat(y).float() - y_p.float()).abs().max().item() < tol
    assert (hT.reshape(B_ * H, N, P) - h_p).abs().max().item() < tol


# the model layout at the models' prefill shapes, bf16, chunk 256: (B, S, H,
# P, N, scale of B and C): mamba2-2.7b (batch 4, 8192 tokens) and jamba's
# N = 16 (batch 4, 4096). At jamba's shape B and C at 0.5 would take the
# largest |y| of so many outputs past 8, where one bf16 ulp is 0.0625 and
# two roundings of nearly equal values differ by more than SSD_BF16_TOL:
# B and C are scaled by 0.125 (mamba2's scale) and the plain |y| is held
# below 8
MODEL_SSD_CASES = [(4, 8192, 80, 64, 128, 0.125), (4, 4096, 128, 64, 16,
                                                    0.125)]


@pytest.mark.parametrize("B_,S,H,P,N,bc_scale", MODEL_SSD_CASES)
def test_ssd_kernel_at_model_shapes(launched, cuda, B_, S, H, P, N,
                                    bc_scale):
    from repro_torch.kernels.ssd.ref import ssd_grouped_ref
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = _packed_model_layout(gen, B_, S, H, 1, P, N, torch.bfloat16,
                                bc_scale)
    before = launched["ssd"]
    got = ssd_ops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    assert launched["ssd"] == before + 1
    assert _ssd_err(got, ssd_grouped_ref(*args, chunk=sk.chunk_len(S, 256))
                    ) < SSD_BF16_TOL


def _ssd_err(got, want) -> float:
    """K2's bf16 (y, hT) against its plain version's at a model's shape,
    whose |y| stays below 8: the larger max abs error."""
    (y, hT), (y_p, h_p) = got, want
    assert y_p.float().abs().max().item() < 8
    return max((y.float() - y_p.float()).abs().max().item(),
               (hT - h_p).abs().max().item())


def _grouped_vs_scan(x, dt, A, Bm, Cm, y, hT):
    """Max abs errors of the kernel's (y, hT) against ssd_scan_ref on the
    broadcast, flat tensors."""
    B_, S, H, P = x.shape
    R = H // Bm.shape[2]
    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(B_ * H, S, t.shape[-1])
    y_p, h_p = ssd_scan_ref(flat(x), dt.permute(0, 2, 1).reshape(B_ * H, S),
                            A.repeat(B_), flat(Bm.repeat_interleave(R, 2)),
                            flat(Cm.repeat_interleave(R, 2)))
    return ((flat(y).float() - y_p.float()).abs().max().item(),
            (hT.reshape(B_ * H, *hT.shape[2:]) - h_p).abs().max().item())


@pytest.mark.parametrize("S", [8191, 8190])
def test_ssd_serving_width_short_chunks(cuda, S):
    """mamba2-2.7b's width (B = 4, H = 80, one group, P = 64, N = 128) at
    prompt lengths whose chunk rule gives Q = 1 (odd S) and Q = 2: the
    call holds its outputs and the chain's scratch (two state slots and a
    flag a head) and no more, and the result agrees with the sequential
    scan."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    args = _packed_model_layout(gen, 4, S, 80, 1, 64, 128, torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, hT = ssd_ops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    outputs = y.numel() * y.element_size() + hT.numel() * 4
    assert torch.cuda.max_memory_allocated() - base <= (
        outputs + sk.scratch_bytes(4 * 80, 64, 128) + (4 << 20))
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(hT).all())
    err_y, err_h = _grouped_vs_scan(*args, y, hT)
    assert err_y < SSD_BF16_TOL and err_h < SSD_BF16_TOL


def test_ssd_chain_agrees_with_one_head_at_a_time(cuda):
    """The chain's result does not depend on which blocks take which items:
    heads run together (many chains, tickets shared) give, bit for bit,
    what each head gives alone (one chain, its items in turn); 4 items a
    head, so each state slot is reused."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = _packed_model_layout(gen, 2, 1024, 8, 2, 64, 128, torch.bfloat16)
    y, hT = ssd_ops.ssd(*args, chunk=256)
    x, dt, A, Bm, Cm = args
    for b in (0, 1):
        for h in (0, 5):
            g = h // 4
            one = (x[b:b + 1, :, h:h + 1], dt[b:b + 1, :, h:h + 1],
                   A[h:h + 1], Bm[b:b + 1, :, g:g + 1],
                   Cm[b:b + 1, :, g:g + 1])
            y1, h1 = ssd_ops.ssd(*one, chunk=256)
            assert torch.equal(y1[0, :, 0], y[b, :, h])
            assert torch.equal(h1[0, 0], hT[b, h])
    err_y, err_h = _grouped_vs_scan(*args, y, hT)
    assert err_y < SSD_BF16_TOL and err_h < SSD_BF16_TOL


def test_ssd_repeated_calls_bit_equal(cuda):
    """Three calls in a row, and calls on two streams one after the other,
    give bit-equal y and hT: the flags and the ticket are reset on each
    call's stream, and no sum depends on the order blocks run in."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = _packed_model_layout(gen, 2, 1024, 8, 1, 64, 128, torch.bfloat16)
    outs = [ssd_ops.ssd(*args, chunk=256) for _ in range(3)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        outs.append(ssd_ops.ssd(*args, chunk=256))
    s2.wait_stream(s1)
    with torch.cuda.stream(s2):
        outs.append(ssd_ops.ssd(*args, chunk=256))
    torch.cuda.synchronize()
    for y, hT in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(hT, outs[0][1])


def test_ssd_many_short_chunks_fit_the_grid(cuda):
    """B * (S / Q) = 9 * 8191 chunks, past the 65535 of a grid's y and z
    axes: the kernel still launches and agrees with the scan."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    args = _packed_model_layout(gen, 9, 8191, 2, 1, 16, 16, torch.bfloat16)
    y, hT = ssd_ops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    err_y, err_h = _grouped_vs_scan(*args, y, hT)
    assert err_y < SSD_BF16_TOL and err_h < SSD_BF16_TOL


def test_ssd_kernel_path_copies_nothing(cuda):
    """The model layout goes to the kernel as it is: the only CUDA kernels
    one call runs are the SSD kernel's own (no copy of x, no broadcast of
    B or C, no permute of y)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(6)
    args = _packed_model_layout(gen, 2, 512, 8, 1, 64, 128, torch.bfloat16)
    ssd_ops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_ops.ssd(*args, chunk=256)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if "CUDA" in str(e.device_type) and e.count}
    assert names, "the profiler saw no CUDA kernel"
    assert all("ssd_" in n for n in names), names


def _mamba_cfg():
    return registry.reduce_for_smoke(registry.get("mamba2-2.7b"))


def test_reduced_mamba2_serves_through_the_kernel(launched, cuda):
    cfg = _mamba_cfg().replace(dtype="float32", ssd_impl="pallas")
    params = api.init(streams.model_generator(0, cuda), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    eng = ServeEngine(cfg, params, cap=48, device=cuda)
    scan = ServeEngine(cfg.replace(ssd_impl="scan"), params, cap=48,
                       device=cuda)
    before = launched["ssd"]
    out = eng.generate({"tokens": toks}, steps=8)
    assert launched["ssd"] == before + cfg.n_layers
    assert torch.equal(out, scan.generate({"tokens": toks}, steps=8))
    err = (eng.prefill({"tokens": toks})[0]
           - scan.prefill({"tokens": toks})[0]).abs().max().item()
    assert err < 1e-4


def _moe_cfg(arch):
    """Reduced deepseek-v2-lite (MLA at its real 128 + 64 head dims, so K1
    runs at D = 192), phi3.5-moe (GQA) or jamba (attention at offset 4 of
    each 8-layer period, Mamba-2 elsewhere, MoE at odd offsets) in f32 on
    the kernel paths."""
    cfg = registry.reduce_for_smoke(registry.get(arch))
    if cfg.mla is not None:
        cfg = cfg.replace(mla=dataclasses.replace(
            cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg.replace(dtype="float32", attn_impl="pallas",
                       ssd_impl="pallas")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"])
def test_reduced_moe_models_serve_through_the_kernels(launched, cuda, arch):
    """One K1 launch per attention layer and one K2 launch per Mamba layer
    in a generate; the tokens equal the naive/scan path's."""
    cfg = _moe_cfg(arch)
    params = api.init(streams.model_generator(0, cuda), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    eng = ServeEngine(cfg, params, cap=48, device=cuda)
    plain = ServeEngine(cfg.replace(attn_impl="naive", ssd_impl="scan"),
                        params, cap=48, device=cuda)
    mixers = [s.mixer for s in cfg.layer_specs()]
    before = (launched["flash_attention"], launched["ssd"])
    out = eng.generate({"tokens": toks}, steps=8)
    assert (launched["flash_attention"] - before[0],
            launched["ssd"] - before[1]) == (mixers.count("attn"),
                                             mixers.count("mamba"))
    assert torch.equal(out, plain.generate({"tokens": toks}, steps=8))
    err = (eng.prefill({"tokens": toks})[0]
           - plain.prefill({"tokens": toks})[0]).abs().max().item()
    assert err < 1e-4


def test_mamba2_kernel_forward_vs_scan(cuda):
    """tests/test_kernels.py::test_model_uses_pallas_impl_end_to_end's
    mamba2 half: the bf16 model forward through the kernel and the scan."""
    cfg = _mamba_cfg().replace(ssd_impl="pallas")
    params = api.init(streams.model_generator(0, cuda), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 64), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    logits, _ = api.forward(params, {"tokens": toks}, cfg)
    want, _ = api.forward(params, {"tokens": toks},
                          cfg.replace(ssd_impl="scan"))
    assert (logits - want).abs().max().item() < LOGITS_TOL


def test_qwen3_kernel_forward_vs_naive(launched, cuda):
    """tests/test_kernels.py::test_model_uses_pallas_impl_end_to_end's
    qwen3-32b half: the reduced bf16 model forward through the kernel and
    through naive attention."""
    cfg = registry.reduce_for_smoke(registry.get("qwen3-32b")).replace(
        attn_impl="pallas", q_chunk=16, kv_chunk=16)
    params = api.init(streams.model_generator(0, cuda), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 64), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    before = launched["flash_attention"]
    logits, _ = api.forward(params, {"tokens": toks}, cfg)
    assert launched["flash_attention"] == before + cfg.n_layers
    want, _ = api.forward(params, {"tokens": toks},
                          cfg.replace(attn_impl="naive"))
    assert (logits - want).abs().max().item() < LOGITS_TOL


# --------------------------------------------------------------------------
# CPSL training on the card (no hand kernel: cuDNN convolutions and GEMMs)
# --------------------------------------------------------------------------

def _cpsl_setup():
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import CPSLDataset, DeviceResidentDataset
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
    xtr, ytr, _, _ = synthetic_mnist(600, 10, seed=0)
    idx = non_iid_split(ytr, n_devices=4, samples_per_device=60, seed=0)
    ds = CPSLDataset(xtr, ytr, idx, batch=8)
    cp = CPSL(make_split_model("lenet", 3), CPSLConfig(
        cut_layer=3, n_clusters=2, cluster_size=2, batch_per_device=8))
    return cp, ds, DeviceResidentDataset.from_dataset(ds)


@pytest.mark.parametrize("fused_step", [True, False])
def test_cpsl_round_on_card_matches_cpu(cuda, fused_step):
    """One 2x2 round from the same state and batches: card vs CPU within
    1e-5 per leaf (sums in another order; no ReLU or pool flips at this
    size), step counter and rng words equal."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.core.cpsl import CPSL, to_device
    from repro_torch.data.pipeline import batch_seed
    cp, ds, _ = _cpsl_setup()
    cp = CPSL(cp.split, dataclasses.replace(cp.ccfg, fused_step=fused_step))
    clusters = [[0, 1], [2, 3]]
    state = cp.init_state(streams.model_generator(0, "cpu"))
    outs = []
    for dev in ("cpu", cuda):
        outs.append(cp.run_round(
            tree.map(lambda t: t.to(dev), state),
            lambda m, l, d=dev: {k: to_device(a, d) for k, a in
                                 ds.cluster_batch(clusters[m], seed=batch_seed(
                                     0, 0, m, l)).items()}))
    (s_cpu, m_cpu), (s_card, m_card) = outs
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-5)
    for a, b in zip(tree.leaves(s_cpu), tree.leaves(s_card)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
        else:
            assert torch.equal(b.cpu(), a)


def test_fused_round_runs_without_host_sync(cuda):
    from repro_torch import tree
    from repro_torch.core.cpsl import to_device
    cp, ds, dsd = _cpsl_setup()
    clusters = [[0, 1], [2, 3]]
    state = cp.init_state(streams.model_generator(0, cuda))
    table = to_device(dsd.round_index_table(clusters, 0, 0, 1), cuda)
    weights = to_device(dsd.cluster_weights(clusters), cuda, torch.float32)
    cp.run_round_fused(tree.map(torch.clone, state), dsd.data, table,
                       weights)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, mt = cp.run_round_fused(state, dsd.data, table, weights)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(mt["loss"])) and int(state["step"]) == 2


TRAINER_ROUNDS = 10


def test_trainer_fused_rounds_match_looped_on_card(cuda, tmp_path,
                                                   monkeypatch):
    """``CPSLTrainer`` with Gibbs plans, looped and fused rounds from one
    initial state on the card: every leaf within 1e-6 of its largest
    value (the same kernels on the same data, cuDNN deterministic), and
    the loss of the last round below the first round's."""
    from repro_torch import tree
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.profile import lenet_profile
    from repro_torch.train.trainer import CPSLTrainer, TrainerCfg
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cp, ds, _ = _cpsl_setup()
    state0 = cp.init_state(streams.model_generator(0, cuda))
    states = []
    for fused in (False, True):
        trainer = CPSLTrainer(
            CPSL(cp.split, dataclasses.replace(cp.ccfg, fused_round=fused)),
            ds, lenet_profile(), NetworkCfg(n_devices=4), TrainerCfg(
                rounds=TRAINER_ROUNDS, ckpt_every=TRAINER_ROUNDS,
                ckpt_dir=str(tmp_path / str(fused)), resource_mgmt="gibbs",
                gibbs_iters=20), device=cuda)
        states.append(trainer.run(state=tree.map(torch.clone, state0), v=3))
        losses = [h["loss"] for h in trainer.history]
        assert losses[-1] < losses[0], (fused, losses)
    assert _max_rel(*states) <= 1e-6


# --------------------------------------------------------------------------
# experiment fleets on the card
# --------------------------------------------------------------------------

def _fleet_setup(device, **grid):
    """Cluster sizes (1, 2) over 4 devices, seed 0: (M, K) = (4, 1) and
    (2, 2), padded to (4, 2), one round, eval at its end; ``grid``
    replaces FleetConfig fields."""
    from repro_torch.configs.base import CPSLConfig, FleetConfig
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.train.trainer import FleetRunner
    xtr, ytr, xte, yte = synthetic_mnist(600, 50, seed=0)
    return FleetRunner(xtr, ytr, FleetConfig(**{**dict(
        rounds=1, seeds=(0,), cluster_sizes=(1, 2), n_devices=4,
        samples_per_device=60, eval_every=1), **grid}), CPSLConfig(
        cut_layer=3, batch_per_device=8, local_epochs=1), xte=xte, yte=yte,
        device=device)


def _max_rel(a, b):
    from repro_torch import tree
    return max(float((x.double().cpu() - y.double().cpu()).abs().max())
               / max(1.0, float(x.double().abs().max()))
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def test_padded_fleet_on_card_matches_cpu(cuda):
    """A 2-replica padded fleet from one initial state: card vs CPU within
    1e-5 per leaf, integer leaves equal, the same NaN slots."""
    from repro_torch import tree
    runs = {}
    init = _fleet_setup("cpu").cpsl.init_fleet_state((0, 0), device="cpu")
    for dev in ("cpu", cuda):
        fr = _fleet_setup(dev)
        out = fr.run(tree.map(torch.clone, init))
        runs[str(dev)] = (fr.states, out)
    (s_cpu, o_cpu), (s_card, o_card) = runs["cpu"], runs[str(cuda)]
    assert _max_rel(s_cpu, s_card) <= 1e-5
    for a, b in zip(tree.leaves(s_cpu), tree.leaves(s_card)):
        if not a.dtype.is_floating_point:
            assert torch.equal(a, b.cpu())
    for ra, rb in zip(o_cpu["replicas"], o_card["replicas"]):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-5)
        np.testing.assert_allclose(rb["acc"], ra["acc"], atol=1e-6)


def test_run_fleet_runs_without_host_sync(launched, cuda):
    from repro_torch import tree
    fr = _fleet_setup(cuda)
    states = fr.cpsl.init_fleet_state(fr.plan.seeds, cuda)
    tb = fr.upload()
    kw = dict(eval_data=fr.dsd.eval_data, eval_every=1,
              cluster_mask=tb["cluster_mask"], client_mask=tb["client_mask"])
    fr.cpsl.run_fleet(tree.map(torch.clone, states), fr.dsd.data, tb["idx"],
                      tb["weights"], **kw)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, mt = fr.cpsl.run_fleet(states, fr.dsd.data, tb["idx"],
                                       tb["weights"], **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(mt["loss"]).all())
    assert states["step"].tolist() == [4, 2]
    assert not any(launched.values()), dict(launched)   # no hand kernel


def test_padded_fleet_slots_change_no_output_on_card(cuda, monkeypatch):
    """The sample indices of the padded client slots perturbed: no bit of
    the padded fleet's states, losses or eval changes (cuDNN
    deterministic)."""
    from repro_torch import tree
    from repro_torch.core.cpsl import to_device
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    fr = _fleet_setup(cuda)
    tb = fr.upload()
    states = fr.cpsl.init_fleet_state(fr.plan.seeds, cuda)
    poked = fr.plan.idx.copy()
    pad = ~np.broadcast_to(fr.plan.client_mask[:, None, :, None, :, None],
                           poked.shape)
    assert pad.any()
    poked[pad] = (poked[pad] + 7) % len(fr.dsd.data["image"])
    outs = []
    for idx in (tb["idx"], to_device(poked, cuda)):
        s, m = fr.cpsl.run_fleet(
            tree.map(torch.clone, states), fr.dsd.data, idx, tb["weights"],
            lr_scale=tb["lr_scale"], eval_data=fr.dsd.eval_data,
            eval_every=1, cluster_mask=tb["cluster_mask"],
            client_mask=tb["client_mask"])
        outs.append(tree.leaves(s) + [m["losses"], m["loss"],
                                      m["eval"]["acc"], m["eval"]["loss"]])
    for a, b in zip(*outs):
        if a.dtype.is_floating_point:      # NaN slots compared bit for bit
            a, b = (t.reshape(-1).view(torch.int32) for t in (a, b))
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid", [{}, dict(cluster_sizes=(2,),
                                           lr_scales=(0.5, 1.0))],
                         ids=["sizes", "lr"])
def test_fleet_replica_matches_solo_on_card(cuda, grid):
    """Each replica of the padded fleet (or of an lr grid) against the solo
    ``run_training_fused`` of its own unpadded layout at its lr scale (at
    scale 1.0 the base lr, no scale tensor), on the card: within 1e-5 per
    leaf after the first cluster (later a ReLU or pool crossing can part
    them, see tests/test_torch_fleet.py), integer leaves equal after the
    round."""
    from repro_torch import tree
    from repro_torch.core.cpsl import CPSL
    fr = _fleet_setup(cuda, **grid)
    tb = fr.upload()
    for clusters in (1, None):
        c = slice(None, clusters)

        def cut(t):                         # an lr grid has no masks
            return None if t is None else t[:, c]

        states, _ = fr.cpsl.run_fleet(
            fr.cpsl.init_fleet_state(fr.plan.seeds, cuda), fr.dsd.data,
            tb["idx"][:, :, c], cut(tb["weights"]),
            lr_scale=tb["lr_scale"], cluster_mask=cut(tb["cluster_mask"]),
            client_mask=cut(tb["client_mask"]))
        for e, sp in enumerate(fr.specs):
            Me = min(sp["n_clusters"], clusters or sp["n_clusters"])
            Ke = sp["cluster_size"]
            cp = CPSL(fr.cpsl.split, dataclasses.replace(
                fr.ccfg, n_clusters=Me, cluster_size=Ke))
            lr = None if fr.lr_scale is None or fr.lr_scale[e] == 1.0 \
                else float(fr.lr_scale[e])
            solo, _ = cp.run_training_fused(
                cp.init_state(streams.model_generator(sp["seed"], cuda)),
                fr.dsd.data, fr.plan.idx[e, :, :Me, :, :Ke],
                fr.plan.weights[e, :Me, :Ke], lr_scale=lr)
            for (path, a), (_, b) in zip(tree.flatten_with_path(solo),
                                         tree.flatten_with_path(states)):
                b = b[e][:a.shape[0]] if a.dim() else b[e]
                if not a.dtype.is_floating_point:
                    assert torch.equal(a, b), (e, path)
                elif clusters == 1:
                    err = float((a - b).abs().max()) / max(
                        1.0, float(a.abs().max()))
                    assert err <= 1e-5, (e, path, err)


# --------------------------------------------------------------------------
# split-LM training: the kernels under their autograd.Functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_function_grads_vs_plain(launched, cuda, dtype, tol):
    """K1's Function (kernel forward) against ``chunked_attention``: the
    output and dq/dk/dv (tests/test_kernels.py:72's 1e-4 in f32), GQA
    R = 2, softcap 50, a window shorter than S, q_offset > 0."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, Sq, Skv, G, R, D = 2, 192, 320, 2, 2, 64
    args = (True, 96, 50.0, Skv - Sq)
    q = _randn(gen, B, Sq, G, R, D, dtype=dtype)
    k, v = (_randn(gen, B, Skv, G, D, dtype=dtype) for _ in range(2))
    g = _randn(gen, B, Sq, G, R, D, dtype=dtype)
    outs = []
    for fn in (fa_ops.flash_attention, cm.chunked_attention):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        before = launched["flash_attention"]
        out = fn(*ins, *args)
        outs.append([out] + list(torch.autograd.grad(out, ins, g)))
        assert (launched["flash_attention"] > before) == (
            fn is fa_ops.flash_attention)
    for a, b in zip(*outs):
        a, b = a.detach().float(), b.detach().float()
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_grads_vs_plain(launched, cuda, dtype):
    """K2's Function (kernel forward, B and C per group) against
    ``ssd_chunked`` on the groups broadcast to heads: y, hT and dx, ddt,
    dA, dB, dC (tests/test_kernels.py's 2e-5 in f32; 5e-2 in bf16)."""
    from repro_torch.models import mamba2 as mb
    gen = torch.Generator(device=cuda).manual_seed(12)
    B_, S, H, G, P, N = 2, 384, 4, 2, 64, 128
    x = _randn(gen, B_, S, H, P, dtype=dtype)
    dt = F.softplus(_randn(gen, B_, S, H) - 1.0)
    A = -torch.exp(0.3 * _randn(gen, H))
    Bm, Cm = ((0.5 * _randn(gen, B_, S, G, N)).to(dtype) for _ in range(2))
    gy = _randn(gen, B_, S, H, P, dtype=dtype)
    gh = _randn(gen, B_, H, N, P)
    outs = []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        before = launched["ssd"]
        if kernel:
            y, hT = ssd_ops.ssd(*ins, chunk=128)
        else:
            y, hT = mb.ssd_chunked(ins[0], ins[1], ins[2],
                                   mb._broadcast_groups(ins[3], H),
                                   mb._broadcast_groups(ins[4], H),
                                   chunk=128)
        outs.append([y, hT] + list(torch.autograd.grad((y, hT), ins,
                                                       (gy, gh))))
        assert (launched["ssd"] > before) == kernel
    tol = 2e-5 if dtype == torch.float32 else SSD_BF16_TOL
    for a, b in zip(*outs):
        a, b = a.detach().float(), b.detach().float()
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), err


# K2's backward kernel against ssd_chunked's gradient in f32 on the same
# bf16 values, (B, S, H, G, P, N, chunk)
SSD_BWD_CASES = [
    (4, 4096, 80, 1, 64, 128, 256),   # mamba2-2.7b's server batch
    (2, 4096, 80, 1, 64, 128, 256),   # its device batch (cut v = 1)
    (2, 2048, 128, 1, 64, 16, 256),   # jamba's N = 16
    (2, 384, 8, 8, 64, 64, 128),      # B and C per head (G = H), Q = 128
    (2, 512, 8, 2, 32, 32, 64),       # Q = 64
    (1, 200, 4, 1, 128, 128, 256),    # P = 128; Q = 200, a short last tile
    (1, 331, 6, 2, 16, 64, 256),      # odd S: Q = 1, run 64 rows together
]
# Of the largest value of each gradient, tighter than the Function's bf16
# limit (5e-2, set for the plain path's bf16 results). dx, dB and dC are
# rounded to bf16: half an ulp is up to 2^-8 = 3.9e-3 of the largest value
# (3.4e-3 read on the H100); ddt and dA stay f32, where every f32 operand of
# a product enters as bf16 hi + lo (~2^-16) and sums run in f32 (2.3e-5
# read).
SSD_BWD_TOL = {"dx": 6e-3, "dB": 6e-3, "dC": 6e-3, "ddt": 1e-4, "dA": 1e-4}


def _ssd_bwd_inputs(gen, B_, S, H, G, P, N):
    bf = torch.bfloat16
    x = _randn(gen, B_, S, H, P, dtype=bf)
    dt = F.softplus(_randn(gen, B_, S, H) - 1.0)
    A = -torch.exp(0.3 * _randn(gen, H))
    Bm, Cm = ((0.5 * _randn(gen, B_, S, G, N)).to(bf) for _ in range(2))
    gy = _randn(gen, B_, S, H, P, dtype=bf)
    gh = _randn(gen, B_, H, N, P)
    return x, dt, A, Bm, Cm, gy, gh


def _ssd_plain_grads(x, dt, A, Bm, Cm, gy, gh, chunk):
    """``ssd_chunked``'s gradient in f32 on the same values, B and C
    broadcast to heads: (dx, ddt, dA, dB, dC)."""
    from repro_torch.models import mamba2 as mb
    H = x.shape[2]
    ins = [t.detach().to(torch.float32, copy=True).requires_grad_()
           for t in (x, dt, A, Bm, Cm)]
    y, hT = mb.ssd_chunked(ins[0], ins[1], ins[2],
                           mb._broadcast_groups(ins[3], H),
                           mb._broadcast_groups(ins[4], H), chunk=chunk)
    if gh is None:
        return torch.autograd.grad(y, ins, gy.float())
    return torch.autograd.grad((y, hT), ins, (gy.float(), gh))


def _rel_errs(got, want):
    return {n: float((a.float() - b).abs().max() / b.abs().max())
            for n, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want)}


def _within(errs):
    return all(errs[n] <= SSD_BWD_TOL[n] for n in errs)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("B_,S,H,G,P,N,chunk", SSD_BWD_CASES)
def test_ssd_bwd_kernel_vs_plain(launched, cuda, B_, S, H, G, P, N, chunk,
                                 with_state):
    from repro_torch.kernels.ssd import bwd
    gen = torch.Generator(device=cuda).manual_seed(31)
    x, dt, A, Bm, Cm, gy, gh = _ssd_bwd_inputs(gen, B_, S, H, G, P, N)
    gh = gh if with_state else None
    before = launched["ssd_bwd"]
    got = bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=chunk)
    torch.cuda.synchronize()
    assert launched["ssd_bwd"] == before + 1
    want = _ssd_plain_grads(x, dt, A, Bm, Cm, gy, gh, chunk)
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
    errs = _rel_errs(got, want)
    print("ssd_bwd", (B_, S, H, G, P, N, chunk), with_state, errs)
    assert _within(errs), errs


def test_ssd_bwd_large_decays_stay_finite(cuda):
    """dt |A| = 20 a step: a chunk's cumsum spans far more than exp's
    range, and above the diagonal the decay is never evaluated."""
    from repro_torch.kernels.ssd import bwd
    gen = torch.Generator(device=cuda).manual_seed(35)
    x, dt, A, Bm, Cm, gy, gh = _ssd_bwd_inputs(gen, 1, 512, 4, 1, 64, 64)
    dt = torch.full_like(dt, 2.0)
    A = torch.full_like(A, -10.0)
    got = bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=256)
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    errs = _rel_errs(got, _ssd_plain_grads(x, dt, A, Bm, Cm, gy, gh, 256))
    del errs["dA"]
    assert _within(errs), errs
    # dA: here its rows' terms cancel to ~1e-6 (finite differences of this
    # case in f64 on the CPU), where the plain path reads ~5e-4 in f32 and
    # f64 alike; it is held to the kernel's decomposition in f32
    from repro_torch.kernels.ssd.ref import ssd_bwd_ref
    dA = ssd_bwd_ref(x, dt, A, Bm, Cm, gy, gh, chunk=256)[2]
    assert float((got[2] - dA).abs().max()) < 1e-4, (got[2], dA)


def test_ssd_bwd_repeated_calls_bit_equal(cuda):
    from repro_torch.kernels.ssd import bwd
    gen = torch.Generator(device=cuda).manual_seed(32)
    x, dt, A, Bm, Cm, gy, gh = _ssd_bwd_inputs(gen, 2, 1024, 16, 1, 64, 128)
    outs = [bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=256)
            for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


def test_ssd_bwd_allocates_only_its_scratch(cuda):
    """At mamba2-2.7b's server shape the call's peak beyond its inputs is
    its outputs and the stated scratch (~0.53 GB), under them plus one
    (B, H, Q, Q) f32 tile (84 MB)."""
    from repro_torch.kernels.ssd import bwd
    B_, S, H, G, P, N, chunk = SSD_BWD_CASES[0]
    gen = torch.Generator(device=cuda).manual_seed(33)
    ins = _ssd_bwd_inputs(gen, B_, S, H, G, P, N)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = bwd.ssd_bwd(*ins[:6], None, chunk=chunk)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    scratch = bwd.scratch_bytes(B_, S, H, G, N, P, chunk)
    tile = B_ * H * chunk * chunk * 4
    print("ssd_bwd memory", extra, out_bytes, scratch)
    assert extra < out_bytes + scratch + tile


def test_ssd_function_bf16_backward_is_the_kernel(launched, cuda,
                                                  monkeypatch):
    """The Function's bf16 backward on the card launches the kernel once
    and never reaches ``ssd_chunked``; a backward that reaches only hT
    gives C no gradient."""
    from repro_torch.models import mamba2 as mb
    B_, S, H, G, P, N, chunk = 2, 512, 8, 2, 64, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(34)
    x, dt, A, Bm, Cm, gy, gh = _ssd_bwd_inputs(gen, B_, S, H, G, P, N)
    want = _ssd_plain_grads(x, dt, A, Bm, Cm, gy, gh, chunk)

    def refuse(*a, **k):
        raise AssertionError("the bf16 backward ran ssd_chunked")

    monkeypatch.setattr(mb, "ssd_chunked", refuse)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hT = ssd_ops.ssd(*ins, chunk=chunk)
    before = launched["ssd_bwd"]
    got = torch.autograd.grad((y, hT), ins, (gy, gh))
    assert launched["ssd_bwd"] == before + 1
    assert _within(_rel_errs(got, want))
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    _, hT = ssd_ops.ssd(*ins, chunk=chunk)
    grads = torch.autograd.grad((hT * gh).sum(), ins, allow_unused=True)
    assert grads[4] is None and all(g is not None for g in grads[:4])
    # under remat (a checkpointed layer unpacks the saved inputs once)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hT = torch.utils.checkpoint.checkpoint(
        lambda *a: ssd_ops.ssd(*a, chunk=chunk), *ins, use_reentrant=False)
    again = torch.autograd.grad((y, hT), ins, (gy, gh))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-2.7b"])
def test_split_lm_round_on_card_matches_cpu(launched, cuda, arch):
    """A reduced split LM in f32, one 2 x 2 CPSL round: the card (the
    kernels, launched 2 * (K*v + layers - v) times a step with remat)
    against the CPU (their plain versions), within 1e-4 per leaf."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.cpsl import CPSL, to_device
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import LMClusterData, batch_seed
    from repro_torch.data.synthetic import MarkovLM
    cfg = registry.reduce_for_smoke(registry.get(arch)).replace(
        dtype="float32", attn_impl="pallas", ssd_impl="pallas", remat=True)
    if arch == "gemma2-2b":
        cfg = cfg.replace(pattern=(dataclasses.replace(cfg.pattern[0],
                                                       window=16),
                                   cfg.pattern[1]))
    cp = CPSL(make_split_model(cfg, 1), CPSLConfig(
        cut_layer=1, n_clusters=2, cluster_size=2, batch_per_device=2))
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=0), 4, 2, 48)
    clusters = [[0, 1], [2, 3]]
    batches = [data.cluster_batch(c, seed=batch_seed(0, 0, m, 0))
               for m, c in enumerate(clusters)]
    state = cp.init_state(streams.model_generator(0, "cpu"))
    kernel = ("flash_attention" if arch == "gemma2-2b" else "ssd")
    outs = []
    for dev in ("cpu", cuda):
        before = launched[kernel]
        outs.append(cp.run_round(
            tree.map(lambda t: t.to(dev), state),
            lambda m, l, d=dev: {k: to_device(a, d)
                                 for k, a in batches[m].items()}))
        if dev == cuda:
            # 2 steps of 2 * (K*v + layers - v) at K = 2, v = 1
            assert launched[kernel] - before == 2 * 2 * (2 + cfg.n_layers - 1)
    (s_cpu, m_cpu), (s_card, m_card) = outs
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-5)
    for a, b in zip(tree.leaves(s_cpu), tree.leaves(s_card)):
        if a.dtype.is_floating_point:
            err = float((b.cpu() - a).abs().max()) / max(
                1.0, float(a.abs().max()))
            assert err <= 1e-4, err
        else:
            assert torch.equal(b.cpu(), a)


# --------------------------------------------------------------------------
# whisper: K1 at head dim 64, non-causal, Sq != Skv
# --------------------------------------------------------------------------

# (BHkv, R, Sq, Skv): the encoder's self-attention (ragged against the
# 64-row and 64-key tiles), the decoder's cross-attention at a prompt of
# 64 and of 5 queries over whisper's 1500 frames, and one clip's 12 heads
# of the encoder at its 1500 frames
WHISPER_CASES = [(3, 1, 300, 300), (2, 2, 64, 1500), (4, 1, 5, 1500),
                 (12, 1, 1500, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BHkv,R,Sq,Skv", WHISPER_CASES)
def test_flash_kernel_whisper_shapes_vs_plain(launched, cuda, dtype, BHkv, R,
                                              Sq, Skv):
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = _randn(gen, BHkv * R, Sq, 64, dtype=dtype)
    k = _randn(gen, BHkv, Skv, 64, dtype=dtype)
    v = _randn(gen, BHkv, Skv, 64, dtype=dtype)
    kw = dict(causal=False, window=0, softcap=0.0, q_offset=0, kv_repeat=R)
    before = launched["flash_attention"]
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launched["flash_attention"] == before + 1
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    # non-causal over many keys the outputs are small (~0.1): in bf16,
    # one ulp of the largest output, 2^-7 max|want|, not BF16_TOL, which
    # is about the outputs' own size; two roundings of values that agree
    # far below an ulp differ by at most one ulp
    if dtype == torch.float32:
        assert err < F32_TOL
    else:
        tol = min(BF16_TOL, 2.0 ** -7 * want.float().abs().max().item())
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("BHkv,R,Sq,Skv", WHISPER_CASES)
def test_flash_kernel_whisper_ragged_mask_probe(cuda, BHkv, R, Sq, Skv):
    """bf16 on q ~ N(2, 1), k ~ N(-2, 1): real scores ~ -32, so an
    unmasked key past Skv in the ragged last key tile (score 0 on
    zero-filled rows) would take nearly all the weight."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    q = (_randn(gen, BHkv * R, Sq, 64) + 2).bfloat16()
    k = (_randn(gen, BHkv, Skv, 64) - 2).bfloat16()
    v = _randn(gen, BHkv, Skv, 64, dtype=torch.bfloat16)
    kw = dict(causal=False, window=0, softcap=0.0, q_offset=0, kv_repeat=R)
    got = fk.flash_attention_flat(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = min(BF16_TOL, 2.0 ** -7 * want.float().abs().max().item())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_function_grads_cross_attention(launched, cuda, dtype, tol):
    """K1's Function on whisper's cross-attention form (non-causal, 48
    queries over 300 keys, D = 64, GQA R = 2) against
    ``chunked_attention``: the output and dq/dk/dv."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    B, Sq, Skv, G, R, D = 2, 48, 300, 2, 2, 64
    args = (False, 0, 0.0, 0)
    q = _randn(gen, B, Sq, G, R, D, dtype=dtype)
    k, v = (_randn(gen, B, Skv, G, D, dtype=dtype) for _ in range(2))
    g = _randn(gen, B, Sq, G, R, D, dtype=dtype)
    outs = []
    for fn in (fa_ops.flash_attention, cm.chunked_attention):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        before = launched["flash_attention"]
        out = fn(*ins, *args)
        outs.append([out] + list(torch.autograd.grad(out, ins, g)))
        assert (launched["flash_attention"] > before) == (
            fn is fa_ops.flash_attention)
    for a, b in zip(*outs):
        a, b = a.detach().float(), b.detach().float()
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), err


def _whisper_cfg():
    """Reduced whisper in f32 on the kernel path at head dim 64 and 100
    frames (ragged against the kernel's tiles)."""
    return registry.reduce_for_smoke(registry.get("whisper-small")).replace(
        dtype="float32", attn_impl="pallas", head_dim=64, enc_seq=100)


def test_reduced_whisper_serves_through_the_kernel(launched, cuda):
    """One K1 launch per encoder layer and two per decoder layer (self
    and cross) in a generate's prefill, none in decode; the tokens equal
    the naive path's and the prefill logits are within 1e-4."""
    cfg = _whisper_cfg()
    params = api.init(streams.model_generator(0, cuda), cfg)
    gen = streams.sampler_generator(1, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 20),
                                     device=cuda, generator=gen),
             "frames": torch.randn((2, cfg.enc_seq, cfg.d_model),
                                   device=cuda, generator=gen)}
    eng = ServeEngine(cfg, params, cap=28, device=cuda)
    naive = ServeEngine(cfg.replace(attn_impl="naive"), params, cap=28,
                        device=cuda)
    n_dec = cfg.n_layers - cfg.n_enc_layers
    before = launched["flash_attention"]
    out = eng.generate(batch, steps=8)
    assert launched["flash_attention"] - before == cfg.n_enc_layers + 2 * n_dec
    assert torch.equal(out, naive.generate(batch, steps=8))
    err = (eng.prefill(batch)[0] - naive.prefill(batch)[0]).abs().max()
    assert err.item() < 1e-4


def test_whisper_split_round_on_card_matches_cpu(launched, cuda):
    """A reduced whisper split at v = 1 in f32 with remat, one 2 x 2 CPSL
    round: the card (K1 launched K*v + (n_enc - v) + 4 * n_dec times a
    step: the encoder once, the decoder's self and cross attention twice
    under remat) against the CPU (K1's plain version), within 1e-4 per
    leaf."""
    from repro_torch import tree
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.cpsl import CPSL, to_device
    from repro_torch.core.splitting import make_split_model
    cfg = _whisper_cfg().replace(remat=True)
    cp = CPSL(make_split_model(cfg, 1), CPSLConfig(
        cut_layer=1, n_clusters=2, cluster_size=2, batch_per_device=2))
    rng = np.random.default_rng(0)
    batches = [{"frames": rng.standard_normal(
                    (2, 2, cfg.enc_seq, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (2, 2, 24),
                                       dtype=np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (2, 2, 24),
                                       dtype=np.int32)} for _ in range(2)]
    state = cp.init_state(streams.model_generator(0, "cpu"))
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers - cfg.n_enc_layers
    outs = []
    for dev in ("cpu", cuda):
        before = launched["flash_attention"]
        outs.append(cp.run_round(
            tree.map(lambda t: t.to(dev), state),
            lambda m, l, d=dev: {k: to_device(a, d)
                                 for k, a in batches[m].items()}))
        if dev == cuda:
            assert launched["flash_attention"] - before == 2 * (
                2 * 1 + n_enc - 1 + 4 * n_dec)
    (s_cpu, m_cpu), (s_card, m_card) = outs
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-5)
    for a, b in zip(tree.leaves(s_cpu), tree.leaves(s_card)):
        if a.dtype.is_floating_point:
            err = float((b.cpu() - a).abs().max()) / max(
                1.0, float(a.abs().max()))
            assert err <= 1e-4, err
        else:
            assert torch.equal(b.cpu(), a)


# --------------------------------------------------------------------------
# the wireless-dynamics simulator on the card (no hand-written kernel)
# --------------------------------------------------------------------------

def _sim_fleet_runner(device, **grid):
    from repro_torch.configs.base import SimFleetCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.fleet import SimFleetRunner
    fcfg = SimFleetCfg(**dict(dict(
        rounds=8, seeds=(0, 1), policies=("equal", "greedy", "proposed"),
        cluster_sizes=(3, 4), cuts=(2,), epoch_len=3, gibbs_iters=6,
        gibbs_chains=2, saa_samples=2, saa_gibbs_iters=4, saa_cuts=(1, 2, 3),
        n_reserve=2, min_devices_floor=True), **grid))
    dcfg = DynamicsCfg(rho_snr=0.9, rho_f=0.95, seed=0, p_depart=0.08,
                       p_arrive=0.3, min_devices=4, energy_budget_j=12.0,
                       forced_departures={2: (1,), 4: (0, 5)})
    return SimFleetRunner(lenet_profile(), NetworkCfg(n_devices=12,
                                                      n_subcarriers=15),
                          dcfg, fcfg, device=device)


@pytest.mark.parametrize("chunk", [0, 2])
def test_sim_fleet_card_matches_cpu(cuda, chunk):
    """The small fleet grid (all three policies, SAA, churn with the
    floor, arrivals, energy) on the card and on the CPU: identical
    decisions, floats within 1e-9 relative, and the card's latencies
    against the port's looped NumPy oracle."""
    card = _sim_fleet_runner(cuda, cost_chunk=chunk).run()["trace"]
    cpu_runner = _sim_fleet_runner("cpu", cost_chunk=chunk)
    cpu = cpu_runner.run()["trace"]
    for k in ("dev", "mask", "csize", "xs", "v", "active", "n_active"):
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    for k in ("latency", "cluster_latency", "energy", "f", "rate"):
        rel = np.abs(card[k] - cpu[k]) / np.maximum(np.abs(cpu[k]), 1e-300)
        assert rel.max() <= 1e-9, k
    want = cpu_runner.run_looped()["latency"]
    assert (np.abs(card["latency"] - want) / want).max() <= 1e-9


def test_partition_batch_j_card_matches_numpy(cuda):
    from repro_torch.core.channel import (NetworkCfg, NetworkState,
                                          device_means, sample_network)
    from repro_torch.core.latency import PartitionBatch, PartitionBatchJ
    from repro_torch.core.profile import lenet_profile
    prof = lenet_profile()
    rng = np.random.default_rng(1)
    sizes, R, S = [4, 3, 3], 6, 3
    ncfg = NetworkCfg(n_devices=10, n_subcarriers=20)
    mu = device_means(ncfg, 1)
    nets = [sample_network(ncfg, *mu, rng) for _ in range(S)]
    snet = NetworkState(f=np.stack([n.f for n in nets]),
                        rate=np.stack([n.rate for n in nets]))
    v = rng.integers(1, prof.n_cuts + 1, size=R)
    rows = rng.integers(0, S, size=R)
    dev = np.stack([rng.permutation(10) for _ in range(R)])
    xs = rng.integers(1, 7, size=(R, 10))
    want = PartitionBatch(v, snet, ncfg, prof, 16, 2, sizes, dev,
                          net_rows=rows)
    for chunk in (None, 4):
        got = PartitionBatchJ(v, snet, ncfg, prof, 16, 2, sizes, dev,
                              net_rows=rows, chunk_size=chunk)
        assert got._fd.device.type == "cuda"
        np.testing.assert_allclose(got.cluster_latencies(xs),
                                   want.cluster_latencies(xs), rtol=1e-12)
        np.testing.assert_allclose(got.latencies(xs), want.latencies(xs),
                                   rtol=1e-12)


def test_sim_engine_card_plans(cuda):
    """A 3-round ``SimEngine`` with ``train=False`` on the card makes the
    CPU's decisions (its planner is NumPy on the host either way)."""
    from repro_torch.configs.base import CPSLConfig, SimCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.engine import SimEngine
    from repro_torch.telemetry import jsonable
    traces = []
    for dev in (cuda, "cpu"):
        eng = SimEngine("lenet", None, lenet_profile(),
                        NetworkCfg(n_devices=12, n_subcarriers=24),
                        DynamicsCfg(p_depart=0.1, min_devices=4, seed=2),
                        SimCfg(rounds=3, epoch_len=2, cluster_size=3,
                               saa_samples=2, saa_gibbs_iters=5,
                               gibbs_iters=10, cuts=(2, 3)),
                        CPSLConfig(cluster_size=3), train=False, device=dev)
        assert eng.device.type == torch.device(dev).type
        traces.append(jsonable(eng.run()[1]))
    assert traces[0] == traces[1] and len(traces[0]) == 3


# --------------------------------------------------------------------------
# the Mamba-2 mixer's gated output stage (kernels/gated_norm)
# --------------------------------------------------------------------------

# (rows, W, H): two training sequences of 4096 at mamba2-2.7b's and
# granite's widths, the decode's 4 and 16 rows, ragged row counts
GATED_CASES = [(8192, 5120, 80), (8192, 8192, 128), (4, 5120, 80),
               (16, 8192, 128), (1000, 5120, 80), (37, 128, 8)]
# Against the f64 gradient of the plain version on the same values. An
# output in bf16 is one rounding of the kernel's f32 value: at most half an
# ulp, 2^-8 of the value; one ulp of the largest output, 2^-7 of it, leaves
# room for the f32 arithmetic (the plain bf16 path rounds three times:
# after the skip, after the gate, at the output). In f32 the same
# arithmetic in another order, with rsqrtf and __expf (a few ulps each).
GATED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
# dD and dscale are f32 sums over the rows in another order: within 1e-5
# of the sum of their terms' magnitudes
GATED_SUM_TOL = 1e-5


def _gated_inputs(gen, rows, W, H, dtype):
    """y and x per head (rows, H, P), z (rows, W), as the mixer has them
    (x and z column slices of the conv's and in_proj's rows), D and scale
    f32, dout (rows, W)."""
    y = _randn(gen, rows, H, W // H, dtype=dtype)
    x = _randn(gen, rows, W + 256, dtype=dtype)[:, :W].reshape(y.shape)
    z = _randn(gen, rows, 2 * W + 256 + H, dtype=dtype)[:, :W]
    D = 1.0 + 0.5 * _randn(gen, H)
    scale = 1.0 + 0.1 * _randn(gen, W)
    return y, x, z, D, scale, _randn(gen, rows, W, dtype=dtype)


def _gated_f64(y, x, z, D, scale, dout):
    """The plain version's output and its gradients in f64."""
    from repro_torch.kernels.gated_norm.ref import gated_norm_ref
    leaves = [t.detach().double().requires_grad_()
              for t in (y, x, z, D.to(y.dtype), scale)]
    out = gated_norm_ref(*leaves, 1e-5)
    return (out.detach(),) + torch.autograd.grad(out, leaves, dout.double())


def _gated_rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def _gated_errs(out, grads, want) -> dict:
    """The forward's output (``out``) and the backward's dy, dx and dz
    (``grads``, either may be None) against ``_gated_f64``'s, each of the
    largest value."""
    pairs = [("out", out, want[0])] if out is not None else []
    if grads is not None:
        pairs += zip(("dy", "dx", "dz"), grads[:3], want[1:4])
    return {name: _gated_rel(a, b) for name, a, b in pairs}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,W,H", GATED_CASES)
def test_gated_norm_kernel_vs_plain(launched, cuda, rows, W, H, dtype):
    from repro_torch.kernels.gated_norm import kernel as gk
    from repro_torch.kernels.gated_norm.ref import gated_norm_ref
    gen = torch.Generator(device=cuda).manual_seed(41)
    y, x, z, D, scale, dout = _gated_inputs(gen, rows, W, H, dtype)
    before = dict(launched)
    out, rstd = gk.gated_norm_fwd(y, x, z, D, scale, 1e-5)
    grads = gk.gated_norm_bwd(y, x, z, D, scale, rstd, dout)
    torch.cuda.synchronize()
    assert launched["gated_norm"] == before["gated_norm"] + 1
    assert launched["gated_norm_bwd"] == before["gated_norm_bwd"] + 1
    want = _gated_f64(y, x, z, D, scale, dout)
    for a, b in zip(grads[:3], want[1:4]):
        assert a.shape == b.shape and a.dtype == dtype
    errs = _gated_errs(out, grads, want)
    print("gated_norm", (rows, W, H, dtype), errs)
    assert all(e <= GATED_TOL[dtype] for e in errs.values()), errs
    if dtype == torch.bfloat16:
        # one rounding where the plain bf16 path rounds three times
        plain = gated_norm_ref(y, x, z, D, scale, 1e-5)
        assert errs["out"] <= _gated_rel(plain, want[0])
    # the sums, each within GATED_SUM_TOL of its terms' magnitudes
    x64 = x.double()
    mag_D = (want[1] * x64).abs().sum((0, 2))
    u = y.double() + D.to(dtype).double()[:, None] * x64
    n = u.reshape(rows, W) * F.silu(z.double()) * rstd.double()[:, None]
    mag_s = (dout.double() * n).abs().sum(0)
    for a, b, mag in ((grads[3], want[4], mag_D), (grads[4], want[5], mag_s)):
        assert a.dtype == torch.float32
        assert bool(((a.double() - b).abs() <= GATED_SUM_TOL * mag
                     + 1e-30).all())


def test_gated_norm_repeated_calls_bit_equal(cuda):
    from repro_torch.kernels.gated_norm import kernel as gk
    gen = torch.Generator(device=cuda).manual_seed(42)
    y, x, z, D, scale, dout = _gated_inputs(gen, 8192, 5120, 80,
                                            torch.bfloat16)
    outs = []
    for _ in range(3):
        out, rstd = gk.gated_norm_fwd(y, x, z, D, scale, 1e-5)
        outs.append((out, rstd) + gk.gated_norm_bwd(y, x, z, D, scale, rstd,
                                                    dout))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


def test_gated_norm_refuses_misaligned_operands(launched, cuda):
    from repro_torch.kernels.gated_norm import kernel as gk
    gen = torch.Generator(device=cuda).manual_seed(43)
    y, x, z, D, scale, _ = _gated_inputs(gen, 8, 128, 8, torch.bfloat16)
    wide = _randn(gen, 8, 512, dtype=torch.bfloat16)
    before = launched["gated_norm"]
    for bad in (wide[:, 1:129], wide[:, ::2][:, :128]):
        bad = bad.reshape(y.shape)
        with pytest.raises(ValueError, match="16-byte"):
            gk.gated_norm_fwd(y, bad, z, D, scale, 1e-5)
    assert launched["gated_norm"] == before


def test_reduced_mamba2_training_step_takes_the_gated_norm_kernel(
        launched, cuda):
    """A bf16 step of the reduced mamba2 with remat: the stage's kernel
    twice a Mamba layer (the forward and its recompute), its backward
    once, and every parameter of the stage gets a finite gradient."""
    cfg = _mamba_cfg().replace(ssd_impl="pallas", remat=True)
    params = api.init(streams.model_generator(0, cuda), cfg)
    leaves = [t.requires_grad_() for t in _float_leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    before = dict(launched)
    loss = api.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    n = [s.mixer for s in cfg.layer_specs()].count("mamba")
    assert n >= 1
    assert launched["gated_norm"] - before["gated_norm"] == 2 * n
    assert launched["gated_norm_bwd"] - before["gated_norm_bwd"] == n
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def _float_leaves(params):
    from repro_torch import tree
    return [t for t in tree.leaves(params) if t.is_floating_point()]


# the JAX package's mixer on the CPU, saved by tests/_mamba_jax_ref.py; the
# kernel path holds to it within the f32 SSD limit of the largest |value|:
# K2 and the stage's kernel sum in another order than the reference
MIXER_JAX_TOL = SSD_F32_TOL


def test_mamba_mixer_kernel_path_meets_the_jax_reference(launched, cuda):
    """``mamba_apply`` through K2, the conv and the gated stage's kernels
    in f32 on the card, on the inputs and parameters for which the fixture
    holds the JAX package's mixer: the output and the gradients of x, D
    and the norm's scale under the fixture's cotangent."""
    import _mamba_jax_ref as jref
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import mamba2 as mb
    params, a = jref.load()
    cfg = _mamba_cfg().replace(dtype="float32", ssd_impl="pallas")
    p = params_from_numpy(params, cuda)
    x = torch.from_numpy(a["x"]).to(cuda).requires_grad_()
    leaves = [x, p["D"].requires_grad_(), p["norm"]["scale"].requires_grad_()]
    before = dict(launched)
    out = mb.mamba_apply(p, x, cfg)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(a["cotangent"]).to(cuda))
    # K2's backward kernel is bf16 alone; f32 recomputes the plain scan
    assert {k: launched[k] - before[k] for k in before} == {
        "flash_attention": 0, "ssd": 1, "ssd_bwd": 0, "gated_norm": 1,
        "gated_norm_bwd": 1, "causal_conv": 1, "causal_conv_bwd": 1}
    errs = {name: float((got.detach().cpu() - torch.from_numpy(a[name]))
                        .abs().max() / np.abs(a[name]).max())
            for got, name in zip((out, *grads), ("out", "dx", "dD",
                                                 "dscale"))}
    print("mixer vs JAX", errs)
    assert all(e < MIXER_JAX_TOL for e in errs.values()), errs


# --------------------------------------------------------------------------
# the Mamba-2 mixer's conv stage (kernels/causal_conv)
# --------------------------------------------------------------------------

# (B, S, C, the row width x is a column slice of, its first column, K): the
# train cell's server step and mamba2's prefill at its in_proj rows
# (x at column 5,120 of 10,576), granite's and jamba's widths, C not a
# multiple of 8 and a base off 16 bytes (the scalar path), the reduced
# mixer, S under K and not a multiple of a block's rows, K below 4
CONV_CASES = [(4, 4096, 5376, 10576, 5120, 4), (4, 8192, 5376, 10576, 5120, 4),
              (2, 4096, 8448, 16768, 8192, 4), (2, 4096, 8224, 16544, 8192, 4),
              (3, 1000, 1003, 1100, 40, 4), (2, 513, 512, 600, 1, 4),
              (2, 37, 160, 296, 128, 4), (2, 3, 160, 296, 128, 4),
              (2, 300, 256, 296, 8, 3), (2, 300, 256, 296, 8, 2),
              (2, 300, 256, 296, 8, 1)]
# Against the f64 gradient of the plain version on the same values. An
# output (y, dx) in bf16 is one rounding of the kernel's f32 value: at most
# half an ulp, 2^-8 of the value; one ulp of the largest output, 2^-7 of
# it, leaves room for the f32 arithmetic (the plain bf16 path rounds after
# every tap product and add). In f32 the same arithmetic in another order,
# with __expf (a few ulps).
CONV_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
# dw and db are f32 sums over the rows in another order: within 1e-5 of
# the sum of their terms' magnitudes
CONV_SUM_TOL = 1e-5


def _conv_inputs(gen, B_, S, C, width, col, K, dtype):
    """x (B, S, C) a column slice of (B, S, width) rows, as in_proj's
    output holds xBC; taps, bias and dy as the stage sees them."""
    x = _randn(gen, B_, S, width, dtype=dtype)[..., col:col + C]
    w = _randn(gen, K, C) / 2
    b = _randn(gen, C)
    return x, w, b, _randn(gen, B_, S, C, dtype=dtype)


def _conv_f64(x, w, b, dy):
    """The plain version's output and its gradients in f64, on the taps
    and bias rounded to x's dtype as the stage rounds them; and the sums of
    the magnitudes of dw's and db's terms."""
    from repro_torch.kernels.causal_conv.ref import causal_conv_silu_ref
    leaves = [t.detach().to(x.dtype).double().requires_grad_()
              for t in (x, w, b)]
    out = causal_conv_silu_ref(*leaves)
    grads = torch.autograd.grad(out, leaves, dy.double())
    with torch.no_grad():
        K, S = w.shape[0], x.shape[1]
        x64, w64, b64 = (t.detach() for t in leaves)
        xp = F.pad(x64, (0, 0, K - 1, 0))
        p = b64 + sum(xp[:, k:k + S] * w64[k] for k in range(K))
        s = torch.sigmoid(p)
        g = (dy.double() * s * (1 + p * (1 - s))).abs()
        mags = (torch.stack([(g * xp[:, k:k + S].abs()).sum((0, 1))
                             for k in range(K)]), g.sum((0, 1)))
    return (out.detach(),) + grads, mags


def _conv_errs(out, grads, want) -> dict:
    """The forward's output (``out``) and the backward's dx (``grads``,
    either may be None) against ``_conv_f64``'s, each of the largest
    value."""
    pairs = [("out", out, want[0])] if out is not None else []
    if grads is not None:
        pairs.append(("dx", grads[0], want[1]))
    return {name: _gated_rel(a, b) for name, a, b in pairs}


def _conv_sums_within(grads, want, mags) -> bool:
    return all(a.dtype == torch.float32 and bool(
        ((a.double() - b).abs() <= CONV_SUM_TOL * m + 1e-30).all())
        for a, b, m in zip(grads[1:], want[2:], mags))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_,S,C,width,col,K", CONV_CASES)
def test_causal_conv_kernel_vs_plain(launched, cuda, B_, S, C, width, col, K,
                                     dtype):
    from repro_torch.kernels.causal_conv import kernel as ck
    from repro_torch.kernels.causal_conv.ref import causal_conv_silu_ref
    gen = torch.Generator(device=cuda).manual_seed(51)
    x, w, b, dy = _conv_inputs(gen, B_, S, C, width, col, K, dtype)
    before = dict(launched)
    out = ck.causal_conv_fwd(x, w, b)
    grads = ck.causal_conv_bwd(x, w, b, dy)
    torch.cuda.synchronize()
    assert launched["causal_conv"] == before["causal_conv"] + 1
    assert launched["causal_conv_bwd"] == before["causal_conv_bwd"] + 1
    assert out.shape == grads[0].shape == x.shape
    assert out.dtype == grads[0].dtype == dtype
    want, mags = _conv_f64(x, w, b, dy)
    errs = _conv_errs(out, grads, want)
    print("causal_conv", (B_, S, C, width, col, K, dtype), errs)
    assert all(e <= CONV_TOL[dtype] for e in errs.values()), errs
    if dtype == torch.bfloat16:
        # one rounding where the plain bf16 path rounds at every step
        plain = causal_conv_silu_ref(x, w, b)
        assert errs["out"] <= _gated_rel(plain, want[0])
    assert _conv_sums_within(grads, want, mags)


def test_causal_conv_sequences_start_from_zeros(cuda):
    """Row b's first K - 1 outputs see zeros, not row b - 1's tail (made
    large here), and row b's last dx no g of row b + 1: each sequence of
    the batch gives the bits it gives alone."""
    from repro_torch.kernels.causal_conv import kernel as ck
    gen = torch.Generator(device=cuda).manual_seed(52)
    x, w, b, dy = _conv_inputs(gen, 3, 300, 5376, 10576, 5120, 4,
                               torch.bfloat16)
    x[:, -3:] *= 1000
    dy[:, :3] *= 1000
    out = ck.causal_conv_fwd(x, w, b)
    dx, _, _ = ck.causal_conv_bwd(x, w, b, dy)
    for i in range(3):
        assert torch.equal(out[i:i + 1], ck.causal_conv_fwd(x[i:i + 1], w, b))
        assert torch.equal(dx[i:i + 1], ck.causal_conv_bwd(
            x[i:i + 1], w, b, dy[i:i + 1].contiguous())[0])


def test_causal_conv_repeated_calls_bit_equal(cuda):
    from repro_torch.kernels.causal_conv import kernel as ck
    gen = torch.Generator(device=cuda).manual_seed(53)
    x, w, b, dy = _conv_inputs(gen, 4, 4096, 5376, 10576, 5120, 4,
                               torch.bfloat16)
    outs = [(ck.causal_conv_fwd(x, w, b),) + ck.causal_conv_bwd(x, w, b, dy)
            for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(outs[0], o))


def test_causal_conv_refuses_what_it_cannot_read(launched, cuda):
    from repro_torch.kernels.causal_conv import kernel as ck
    gen = torch.Generator(device=cuda).manual_seed(54)
    x, w, b, _ = _conv_inputs(gen, 2, 64, 160, 296, 128, 4, torch.bfloat16)
    before = dict(launched)
    with pytest.raises(ValueError, match="unit last stride"):
        ck.causal_conv_fwd(_randn(gen, 2, 64, 320, dtype=torch.bfloat16)
                           [..., ::2], w, b)
    with pytest.raises(ValueError, match="at most 4"):
        ck.causal_conv_fwd(x, _randn(gen, 5, 160), b)
    assert dict(launched) == before


def test_reduced_mamba2_training_step_takes_the_conv_kernel(launched, cuda):
    """A bf16 step of the reduced mamba2 with remat: the conv stage's kernel
    twice a Mamba layer (the forward and its recompute), its backward once,
    and every parameter gets a finite gradient."""
    cfg = _mamba_cfg().replace(ssd_impl="pallas", remat=True)
    params = api.init(streams.model_generator(0, cuda), cfg)
    leaves = [t.requires_grad_() for t in _float_leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=streams.sampler_generator(1, cuda))
    before = dict(launched)
    loss = api.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    n = [s.mixer for s in cfg.layer_specs()].count("mamba")
    assert n >= 1
    assert launched["causal_conv"] - before["causal_conv"] == 2 * n
    assert launched["causal_conv_bwd"] - before["causal_conv_bwd"] == n
    assert all(bool(torch.isfinite(g).all()) for g in grads)
