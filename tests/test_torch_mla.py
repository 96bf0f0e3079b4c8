"""Port parity for MLA (DeepSeek-V2 multi-head latent attention):
``mla_project_latent`` and ``mla_apply`` in both branches against the JAX
reference on the CPU, in float32, and the flash kernel's plain version at
the head dim MLA prefill gives it (qk_nope + qk_rope = 128 + 64 = 192).

Two sets of MLA dims: the reduced config's (16 + 8, not a kernel head
dim) and deepseek-v2-lite's (128 + 64, v 128). The reference runs its
Pallas flash kernel in interpret mode, as its own tests run it; the port
runs each of its attention impls. Parameters come from the reference's
``mla_init`` through ``params_from_numpy``; activations are numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLACfg as JMLACfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.flash_attention.kernel import \
    flash_attention_flat as jflash_flat
from repro.models import common as jcm
from repro_torch.configs.base import MLACfg, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch import telemetry
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import common as cm

TOL = 1e-5
F32_TOL, BF16_TOL = 2e-5, 3e-2   # tests/test_kernels.py: kernel vs oracle
ABSORBED_TOL = 1e-4              # tests/test_components.py: absorbed vs
                                 # materialised
S = 16

DIMS = {"small": dict(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        "d192": dict(kv_lora_rank=64, qk_nope_head_dim=128,
                     qk_rope_head_dim=64, v_head_dim=128)}


def _cfgs(dims, impl="naive", jimpl="pallas"):
    kw = dict(name="t", family="moe", d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab_size=64, attn_kind="mla",
              dtype="float32", q_chunk=8, kv_chunk=8)
    return (JModelConfig(mla=JMLACfg(**DIMS[dims]), attn_impl=jimpl, **kw),
            ModelConfig(mla=MLACfg(**DIMS[dims]), attn_impl=impl, **kw))


@pytest.fixture(scope="module", params=list(DIMS))
def mla(request):
    jcfg, cfg = _cfgs(request.param)
    jp = jcm.mla_init(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, cfg, jp, params_from_numpy(
        jax.device_get(jp), "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


def test_mla_init_matches_reference_tree(mla):
    _, jcfg, cfg, jp, _ = mla
    tp = cm.mla_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        for leaf in jp[name]:
            assert tuple(tp[name][leaf].shape) == jp[name][leaf].shape
            assert tp[name][leaf].dtype == torch.float32


@pytest.mark.parametrize("offset", [0, 5])
def test_mla_project_latent(mla, offset):
    _, jcfg, cfg, jp, tp = mla
    x = _x(1, (2, S, cfg.d_model))
    pos = np.arange(S) + offset
    ckv_j, kr_j = jcm.mla_project_latent(jp, jnp.asarray(x), jcfg,
                                         jnp.asarray(pos))
    ckv, kr = cm.mla_project_latent(tp, torch.from_numpy(x), cfg,
                                    torch.from_numpy(pos))
    assert ckv.shape == (2, S, cfg.mla.kv_lora_rank)
    assert kr.shape == (2, S, cfg.mla.qk_rope_head_dim)
    assert _err(ckv, ckv_j) < TOL and _err(kr, kr_j) < TOL


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_mla_apply_materialised(mla, impl):
    """Prefill: the port's attention impls against the reference's Pallas
    kernel (interpret mode) at the grouped layout G = H, R = 1."""
    _, jcfg, cfg, jp, tp = mla
    x = _x(2, (2, S, cfg.d_model))
    want = jcm.mla_apply(jp, jnp.asarray(x), jcfg, causal=True)
    with telemetry.LaunchCounter() as launched:
        got = cm.mla_apply(tp, torch.from_numpy(x),
                           cfg.replace(attn_impl=impl), causal=True)
    assert launched["flash_attention"] == 0   # CPU: the plain version
    assert got.shape == (2, S, cfg.d_model)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("pos", [0, S - 1, S + 2])
def test_mla_apply_absorbed_decode(mla, pos):
    """Decode: one query at ``pos`` over a latent cache of capacity S + 4
    holding positions 0..pos, absorbed, against the reference's."""
    _, jcfg, cfg, jp, tp = mla
    cap = S + 4
    x = _x(3, (2, cap, cfg.d_model))
    ckv_j, kr_j = jcm.mla_project_latent(jp, jnp.asarray(x), jcfg,
                                         jnp.arange(cap))
    keep = (jnp.arange(cap) <= pos)[None, :, None]
    latent_j = (ckv_j * keep, kr_j * keep)
    latent = tuple(torch.from_numpy(np.asarray(t)) for t in latent_j)
    h = x[:, pos:pos + 1]
    want = jcm.mla_apply(jp, jnp.asarray(h), jcfg, causal=False,
                         positions=jnp.full((1,), pos), latent=latent_j,
                         kv_valid_len=pos + 1, absorbed=True)
    got = cm.mla_apply(tp, torch.from_numpy(h), cfg, causal=False,
                       positions=torch.full((1,), pos), latent=latent,
                       kv_valid_len=pos + 1, absorbed=True)
    assert got.shape == (2, 1, cfg.d_model)
    assert _err(got, want) < TOL


def test_mla_absorbed_equals_materialised(mla):
    _, _, cfg, _, tp = mla
    x = torch.from_numpy(_x(4, (2, 12, cfg.d_model)))
    y1 = cm.mla_apply(tp, x, cfg, causal=True, absorbed=False)
    y2 = cm.mla_apply(tp, x, cfg, causal=True, absorbed=True)
    assert float((y1 - y2).abs().max()) < ABSORBED_TOL


# (BHkv, R, Sq, Skv, causal, window, softcap, q_offset, bf16)
D192_CASES = [
    (4, 1, 96, 96, True, 0, 0.0, 0, False),      # MLA prefill: G = H, R = 1
    (2, 2, 64, 128, True, 48, 50.0, 64, False),  # GQA, window, offset, cap
    (2, 1, 80, 80, False, 0, 0.0, 0, False),
    (4, 1, 64, 64, True, 0, 0.0, 0, True),
    (2, 1, 96, 96, True, 32, 0.0, 0, True),
]


@pytest.mark.parametrize("BHkv,R,Sq,Skv,causal,window,cap,q_offset,bf16",
                         D192_CASES)
def test_attention_ref_d192_vs_jax_flash_kernel(BHkv, R, Sq, Skv, causal,
                                                window, cap, q_offset, bf16):
    D = 192
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((BHkv * R, Sq, D), (BHkv, Skv, D), (BHkv, Skv, D)))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset,
              kv_repeat=R)
    want = jflash_flat(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                       interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tdt and got.shape == (BHkv * R, Sq, D)
    assert _err(got, want) < (BF16_TOL if bf16 else F32_TOL)
    # the wrapper takes D = 192 and, on CPU tensors, is the plain version
    assert 192 in fk.HEAD_DIMS
    assert torch.equal(fk.flash_attention_flat(tq, tk, tv, **kw), got)
