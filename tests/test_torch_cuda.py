"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the serving path through them.

Every test is marked ``requires_cuda`` and skips on a host without a card
(the kernels have no CPU mode). The file imports neither JAX nor the
reference, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import streams
from repro_torch.configs import registry
from repro_torch.configs.base import LayerSpec
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.serving.engine import ServeEngine

F32_TOL, BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py: kernel vs oracle

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, device=gen.device, generator=gen).to(dtype)


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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BHkv,R,Sq,Skv,D,causal,window,cap,q_offset",
                         FLAT_CASES)
def test_flash_kernel_vs_plain(cuda, dtype, BHkv, R, Sq, Skv, D, causal,
                               window, cap, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, BHkv * R, Sq, D, dtype=dtype)
    k = _randn(gen, BHkv, Skv, D, dtype=dtype)
    v = _randn(gen, BHkv, Skv, D, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    before = fk.launches
    got = fk.flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err < (F32_TOL if dtype == torch.float32 else BF16_TOL)


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


def test_reduced_gemma2_serves_through_the_kernel(cuda):
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
    before = fk.launches
    out = eng.generate({"tokens": toks}, steps=8)
    assert fk.launches == before + cfg.n_layers
    assert torch.equal(out, naive.generate({"tokens": toks}, steps=8))
    err = (eng.prefill({"tokens": toks})[0]
           - naive.prefill({"tokens": toks})[0]).abs().max().item()
    assert err < 1e-4
