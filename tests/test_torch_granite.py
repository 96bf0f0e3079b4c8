"""granite-4.0-h-small in the port, held on the CPU to the benchmark's plain
float32 reference (``perfbench/reference/granite.py``, the one reference
of the model): NoPE GQA with the attention multiplier, the MoE with its
wider shared MLP, the Mamba-2 mixer, the whole forward's logits, and a
prefill then decode steps through the hybrid cache (k/v beside conv
windows and SSM states) against the reference's full forward. Also: the
published configuration, its FLOP count, and that the new config fields
add no op to the models that leave them at their defaults.

The model is the registry's ``reduce_for_smoke`` of the config: a period
of 10 with the attention at offset 5, the published multipliers, NoPE, 8
experts top-2 beside a shared MLP of width 48 (one expert is 32 wide),
computed in float32 with bfloat16 parameters and a float32 router, as
served. The port's parameters are drawn as the benchmark's driver draws
them (``perfbench/drivers/serve_ssm.py::params``), so the reference draws
the same values again from the seed.
"""
import collections
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.drivers import serve_ssm  # noqa: E402
from perfbench.reference import granite as ref  # noqa: E402
from perfbench.reference.precision import Precision  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mamba2 as mb  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

SEED = 2**31 + 5
F32 = Precision("float32")

# ibm-granite/granite-4.0-h-small's config.json, as published
PUBLISHED = {
    "hidden_size": 4096, "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 8, "vocab_size": 100352,
    "intermediate_size": 768, "shared_intermediate_size": 1536,
    "num_local_experts": 72, "num_experts_per_tok": 10,
    "mamba_n_heads": 128, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_expand": 2,
    "mamba_chunk_size": 256, "rms_norm_eps": 1e-05,
    "embedding_multiplier": 12, "residual_multiplier": 0.22,
    "attention_multiplier": 0.0078125, "logits_scaling": 16,
    "position_embedding_type": "nope", "tie_word_embeddings": True,
    "layer_types": (["mamba"] * 5 + ["attention"] + ["mamba"] * 4) * 4,
}


def ref_cfg(cfg) -> dict:
    """The reference's configuration (the configuration file's keys) of a
    granite ModelConfig."""
    s, m, u = cfg.ssm, cfg.moe, cfg.mup
    return {
        "model_type": "granitemoehybrid", "port_arch": cfg.name,
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "layer_types": ["attention" if x.mixer == "attn" else "mamba"
                        for x in cfg.layer_specs()],
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "vocab_size": cfg.vocab_size, "intermediate_size": m.d_ff_expert,
        "shared_intermediate_size": m.d_ff_shared,
        "num_local_experts": m.n_experts, "num_experts_per_tok": m.top_k,
        "mamba_n_heads": s.expand * cfg.d_model // s.headdim,
        "mamba_d_head": s.headdim, "mamba_d_state": s.d_state,
        "mamba_n_groups": s.ngroups, "mamba_d_conv": s.d_conv,
        "mamba_expand": s.expand, "mamba_chunk_size": s.chunk_size,
        "mamba_conv_bias": True, "mamba_proj_bias": False,
        "attention_bias": False, "hidden_act": "silu",
        "normalization_function": "rmsnorm",
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "position_embedding_type": "rope" if cfg.rope else "nope",
        "tie_word_embeddings": cfg.tie_embeddings,
        "embedding_multiplier": u.embedding_multiplier,
        "residual_multiplier": u.residual_multiplier,
        "attention_multiplier": u.attention_multiplier,
        "logits_scaling": u.logits_scaling,
        "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "router_dtype": "float32", "attn_impl": cfg.attn_impl,
        "ssd_impl": cfg.ssd_impl, "moe_group_size": m.group_size,
        "moe_capacity_factor": m.capacity_factor,
        "moe_drop_above_tokens": 4096,
    }


def small(dtype="float32"):
    return registry.reduce_for_smoke(
        registry.get("granite-4.0-h-small")).replace(dtype=dtype)


@pytest.fixture(scope="module")
def model():
    cfg = small()
    rcfg = ref_cfg(cfg)
    params = serve_ssm.params(
        SimpleNamespace(seed=SEED, device=torch.device("cpu"), cfg=rcfg), cfg)
    return cfg, rcfg, params


def _layer(params, cfg, layer):
    """The port's params of ``layer`` and the reference's of it."""
    n, q = divmod(layer, len(cfg.pattern))
    return tfm._index(params["stack"][q], n)


def _x(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


# Tolerances, each as a share of the largest value compared. Both sides
# compute in float32 from the same bfloat16-valued weights, so they differ
# only by the order of float32 sums (chunked vs quadratic SSD, the MoE's
# one-hot dispatch vs the reference's gather, online vs whole softmax):
# the port reads ~1-2e-7 of the largest value for a sublayer and ~2e-6
# for the logits, whose 20 layers and final norm compound it. Each limit
# leaves 10x room or more above those readings and lies far below the
# same path in bfloat16, which each test also runs and which must fail it
# (bf16 rounds each operand at 2^-9 relative: 3e-3 to 7e-3 for a
# sublayer).
TOL_SUBLAYER = 5e-6
TOL_LOGITS = 2e-5
S = 20                   # no multiple of the chunk of 8: the reference pads


def _bf16_fails(fn, tol):
    got, want = fn(small("bfloat16"))
    err = _rel(got, want)
    assert err > tol, f"bf16 reads {err:.3g}, within the f32 limit {tol}"


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_nope_gqa_with_attention_multiplier(model, impl):
    cfg, rcfg, params = model
    layer = 5                                   # the period's attention
    x = _x(1, (2, S, cfg.d_model))

    def run(c):
        p = _layer(params, c, layer)
        got = cm.gqa_apply(p["attn"], x.to(cm.cdtype(c)), c, causal=True,
                           impl=impl)
        want = ref.attention(ref.layer_params(rcfg, SEED, layer, "cpu"), x,
                             rcfg, F32)
        return got, want
    assert _rel(*run(cfg)) < TOL_SUBLAYER
    _bf16_fails(run, TOL_SUBLAYER)


@pytest.mark.parametrize("path", ["dispatch", "naive"])
def test_moe_with_wider_shared_mlp(model, path):
    cfg, rcfg, params = model
    layer = 3
    u = _x(6, (2, S, cfg.d_model))
    assert params["stack"][0]["moe"]["shared"]["w_up"]["w"].shape[-1] == 48

    def run(c):
        p = _layer(params, c, layer)["moe"]
        if path == "dispatch":
            got, _ = cm.moe_apply(p, u.to(cm.cdtype(c)), c, no_drop=True)
        else:
            got = cm.moe_apply_naive(p, u.to(cm.cdtype(c)), c)
        want = ref.moe(ref.layer_params(rcfg, SEED, layer, "cpu"), u, rcfg,
                       S, F32, drop=False)
        return got, want
    assert _rel(*run(cfg)) < TOL_SUBLAYER
    _bf16_fails(run, TOL_SUBLAYER)


def test_mamba_mixer(model):
    cfg, rcfg, params = model
    layer = 2
    x = _x(7, (2, S, cfg.d_model))

    def run(c):
        p = _layer(params, c, layer)["mamba"]
        got = mb.mamba_apply(p, x.to(cm.cdtype(c)), c)
        want = ref.mamba(ref.layer_params(rcfg, SEED, layer, "cpu"), x,
                         rcfg, F32)
        return got, want
    assert _rel(*run(cfg)) < TOL_SUBLAYER
    _bf16_fails(run, TOL_SUBLAYER)


def _tokens(cfg, rows, n):
    g = torch.Generator().manual_seed(11)
    return torch.randint(0, cfg.vocab_size, (rows, n), generator=g)


def test_forward_logits(model):
    cfg, rcfg, params = model
    tokens = _tokens(cfg, 2, S)

    def run(c):
        with torch.no_grad():
            got, _ = tfm.forward(params, tokens, c)
        want = ref.logits(rcfg, SEED, tokens, S, 0, "cpu", F32, 2)
        return got, want
    assert _rel(*run(cfg)) < TOL_LOGITS
    _bf16_fails(run, TOL_LOGITS)


def test_prefill_then_decode_through_the_hybrid_cache(model):
    """A prefill of 20 tokens, then 5 decode steps fed known tokens
    through the cache (each attention layer's k/v, each Mamba layer's conv
    window and SSM state, written in place), against the reference's full
    forward over the same 25 tokens, logits at each of the 6 positions."""
    cfg, rcfg, params = model
    steps = 5
    tokens = _tokens(cfg, 2, S + steps)
    want = ref.logits(rcfg, SEED, tokens, S, S - 1, "cpu", F32, 2)

    def run(c):
        with torch.inference_mode():
            logits, cache = tfm.prefill(params, tokens[:, :S], c,
                                        cap=S + steps)
            got = [logits]
            for i in range(steps):
                logits, cache = tfm.decode_step(params, cache,
                                                tokens[:, S + i], S + i, c)
                got.append(logits)
        return torch.stack(got, 1), want
    kinds = [sorted(c) for c in tfm.init_cache(cfg, 2, S + steps)["stack"]]
    assert kinds == [["conv", "ssm"]] * 5 + [["k", "v"]] + [["conv", "ssm"]] * 4
    got, _ = run(cfg)
    for i in range(steps + 1):
        assert _rel(got[:, i], want[:, i]) < TOL_LOGITS, i
    _bf16_fails(run, TOL_LOGITS)


# -- the published configuration and its FLOPs -------------------------------

def test_registry_config_is_the_published_model():
    cfg = registry.get("granite-4.0-h-small")
    got = ref_cfg(cfg)
    for key, value in PUBLISHED.items():
        assert got[key] == value, key
    assert cfg.n_periods == 4 and cfg.moe.n_shared_experts == 1
    assert "granite-4.0-h-small" in registry.list_port_archs()
    assert "granite-4.0-h-small" not in registry.list_archs()


def test_benchmark_file_is_the_published_model_cut_in_depth():
    """The benchmark's configuration file states the published keys but
    the two it lists as cut (``num_hidden_layers``, ``layer_types``), and
    those as the first 20 layers."""
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in man["configs"]
                 if c["name"] == "granite-4.0-h-small")
    assert entry["reduced"] == ["num_hidden_layers", "layer_types"]
    file = json.loads((ROOT / entry["file"]).read_text())
    for key, value in PUBLISHED.items():
        if key == "num_hidden_layers":
            assert file[key] == 20
        elif key == "layer_types":
            assert file[key] == value[:20]
        else:
            assert file[key] == value, key
    assert serve_ssm.port_config(file) == registry.get(
        "granite-4.0-h-small").replace(n_layers=20)


def test_active_matmul_params_by_hand():
    """Per layer: Mamba-2 in_proj 4096 x (2 x 8192 + 2 x 128 + 128) and
    out_proj 8192 x 4096 (102.24 M), GQA 4096 x (4096 + 2 x 1024) + 4096 x
    4096 (41.94 M), the MoE's 10 chosen SwiGLU experts 3 x 4096 x 768 x 10
    and its shared MLP 3 x 4096 x 1536 (113.25 M); the tied head 4096 x
    100352 (411.04 M): 8.79 B for the published 40 layers, 4.60 B for the
    20 the benchmark runs."""
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 4096 * (4096 + 2 * 1024) + 4096 * 4096
    moe = 3 * 4096 * 768 * 10 + 3 * 4096 * 1536
    head = 4096 * 100352
    cfg = registry.get("granite-4.0-h-small")
    full = roofline.active_matmul_params(cfg)
    assert full == 36 * mamba + 4 * attn + 40 * moe + head
    assert round(full / 1e9, 2) == 8.79
    cut = roofline.active_matmul_params(cfg.replace(n_layers=20))
    assert cut == 18 * mamba + 2 * attn + 20 * moe + head
    assert round(cut / 1e9, 2) == 4.60
    # a prefill's model FLOPs: 2 N tokens, the SSD state and NoPE scores
    shape = ShapeCfg("x", 4096, 16, "prefill")
    state = 4 * 128 * 128 * 64
    scores = 2 * 2048 * 32 * 128 * 2
    tokens = 16 * 4096
    assert roofline.model_flops(cfg.replace(n_layers=20), shape) == \
        pytest.approx(2 * cut * tokens + (18 * state + 2 * scores) * tokens,
                      rel=1e-12)


# -- the defaults add no op ---------------------------------------------------

class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


# read at the commit before the fields existed (CPU); the mamba2 forward
# has one cat a layer fewer since the mixer reads xBC as in_proj's slice
DEEPSEEK_DECODE_OPS = {
    "__iand__": 3, "add": 32, "amax": 3, "arange": 16, "cat": 12,
    "chunk": 6, "clamp": 5, "copy_": 6, "cos": 6, "cumsum": 4, "div": 16,
    "einsum": 26, "eq": 4, "exp": 3, "full": 3, "full_like": 3, "index": 1,
    "lt": 5, "matmul": 21, "mean": 14, "mul": 86, "ones": 3, "pow": 6,
    "reciprocal": 6, "reshape": 19, "rsqrt": 10, "select": 45, "silu": 5,
    "sin": 6, "slice": 10, "softmax": 2, "sort": 2, "split_with_sizes": 6,
    "sub": 13, "sum": 11, "to": 113, "unsqueeze": 44, "where": 5,
    "zeros": 6}
MAMBA_FORWARD_OPS = {
    "add": 31, "arange": 1, "cat": 2, "cumsum": 4, "einsum": 16, "exp": 18,
    "expand": 4, "full": 4, "index": 1, "matmul": 5, "mean": 5,
    "movedim": 8, "mul": 47, "neg": 2, "numpy_T": 1, "ones": 2, "pad": 2,
    "reshape": 12, "rsqrt": 5, "select": 12, "silu": 4, "slice": 28,
    "softplus": 2, "split_with_sizes": 4, "sub": 8, "to": 62, "tril": 2,
    "unbind": 9, "unsqueeze": 26, "where": 4, "zeros": 5}


def test_defaults_add_no_op():
    """With ``rope`` True, no ``mup`` and no ``d_ff_shared``, a reduced
    deepseek-v2-lite decode step and a reduced mamba2-2.7b forward dispatch
    the ops they did before those fields existed, op by op."""
    for arch in ("deepseek-v2-lite-16b", "mamba2-2.7b"):
        cfg = registry.get(arch)
        assert cfg.rope and cfg.mup is None
        assert cfg.moe is None or cfg.moe.d_ff_shared == 0
    cfg = registry.reduce_for_smoke(registry.get("deepseek-v2-lite-16b"))
    gen = torch.Generator().manual_seed(0)
    p = tfm.init(gen, cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    with torch.inference_mode():
        _, cache = tfm.prefill(p, tok, cfg, cap=12)
        with _Ops() as c:
            tfm.decode_step(p, cache, tok[:, -1], 8, cfg)
    assert dict(c.ops) == DEEPSEEK_DECODE_OPS
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b"))
    gen = torch.Generator().manual_seed(0)
    p = tfm.init(gen, cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    with torch.inference_mode(), _Ops() as c:
        tfm.forward(p, tok, cfg)
    assert dict(c.ops) == MAMBA_FORWARD_OPS


def test_generate_spans_of_the_mixers(model):
    """Traced, each decode step of the hybrid holds each layer's mixer
    span (``mamba`` or ``attn``) and then its MoE's, in layer order; the
    prefill the same."""
    from repro_torch import telemetry
    from repro_torch.serving.engine import ServeEngine
    cfg, _, params = model

    class Record:
        def span(self, name, seconds):
            pass

    eng = ServeEngine(cfg, params, cap=S + 3, device="cpu")
    telemetry.reset()
    rec = Record()
    telemetry.observers.append(rec)
    try:
        eng.generate({"tokens": _tokens(cfg, 2, S)}, steps=3)
    finally:
        telemetry.observers.remove(rec)
    spans = telemetry.spans()
    telemetry.reset()
    layers = [n for spec in cfg.layer_specs() for n in (spec.mixer, "moe")]
    phases = [s for s in spans if s.name in ("serve.prefill", "serve.decode")]
    assert len(phases) == 3
    for ph in phases:
        assert [s.name for s in spans if s.parent == ph.id] == layers
