"""The port's launch tooling against the reference: ``launch/mesh.py``,
``launch/roofline.py``, ``core/partitioning.py``, ``launch/hlo_analysis.py``
(the op counter that stands in for the HLO parse) and ``launch/dryrun.py``.

The reference modules come through ``tests/_cpsl_ref.py::reference()`` in
a module-scoped fixture. ``repro.launch.dryrun`` is never imported: its
first lines set ``XLA_FLAGS`` to 512 host devices, which would change the
device count of every later test file in the same worker.

Counter against the reference's parse: the reference's steps are jitted on
one CPU device and ``repro.launch.hlo_analysis.report`` parses the
compiled text. XLA's CPU backend keeps the model's products as ``dot``
ops (the parse counts them; only top-k routing becomes a custom-call), so
the FLOPs compare directly. The port's chunked attention skips the tiles
that the causal mask hides entirely, which the reference's scan computes,
so both run with one attention tile (q_chunk = kv_chunk = S).
"""
import dataclasses
import importlib
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import streams, telemetry, tree
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, MeshConfig, ShapeCfg
from repro_torch.core import partitioning as pt
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import dryrun, hlo_analysis, mesh, roofline

ROOT = Path(__file__).resolve().parent.parent
# one reduced model of each family
FAMILIES = ["gemma2-2b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b",
            "mamba2-2.7b", "jamba-v0.1-52b", "whisper-small"]
S, B, K = 16, 2, 2        # tokens, sequences (a client's), clients
PARSE_RTOL = 0.01         # counter vs the reference's HLO parse
REF_RECORD_KEYS = {"arch", "cell", "mesh", "tag", "profile", "ccfg",
                   "n_devices", "lower_s", "compile_s", "overrides",
                   "memory", "xla_cost", "parsed", "roofline", "total_s"}


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as mods:
        for short, name in (("roofline", "repro.launch.roofline"),
                            ("mesh", "repro.launch.mesh"),
                            ("hlo", "repro.launch.hlo_analysis"),
                            ("partitioning", "repro.core.partitioning"),
                            ("api", "repro.models.api")):
            setattr(mods, short, importlib.import_module(name))
        yield mods


def _cfgs(ref, arch):
    """(reference cfg, port cfg): reduced, f32, one attention tile; jamba
    at one period (8 layers: attention, Mamba, dense and MoE FFNs)."""
    kw = dict(dtype="float32", q_chunk=S, kv_chunk=S)
    if arch == "jamba-v0.1-52b":
        kw["n_layers"] = 8
    return (ref.registry.reduce_for_smoke(ref.registry.get(arch)).replace(
        **kw), registry.reduce_for_smoke(registry.get(arch)).replace(**kw))


# -- mesh and roofline --------------------------------------------------------

def test_mesh_is_one_card():
    m = mesh.make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model") and m.size == 1
    assert mesh.make_host_mesh(1, 1, 1, device="cpu").shape == {
        "data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh.make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="one card has no pod"):
        mesh.make_production_mesh(multi_pod=True)
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == (
        989e12, 3.35e12, 900e9)
    assert MeshConfig(2, 4, 2).n_devices == 16


def test_port_keeps_no_tpu_constant():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for v5e in ("197e12", "819e9", "50e9"):
            assert v5e not in text, (path, v5e)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_model_flops_equal_reference(ref, arch):
    jcfg, cfg = ref.registry.get(arch), registry.get(arch)
    assert roofline.active_matmul_params(cfg) == \
        ref.roofline.active_matmul_params(jcfg)
    for name, shape in SHAPES.items():
        jshape = ref.configs.SHAPES[name]
        for ctx in (shape.seq_len // 2, shape.seq_len):
            assert roofline.attention_flops_per_token(cfg, ctx) == \
                ref.roofline.attention_flops_per_token(jcfg, ctx)
        assert roofline.model_flops(cfg, shape) == \
            ref.roofline.model_flops(jcfg, jshape), name


def test_roofline_terms_are_the_reference_at_h100_constants(ref,
                                                            monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ref.roofline, name, getattr(mesh, name))
    parsed = {"parsed_flops_per_device": 3.1e15,
              "parsed_hbm_bytes_per_device": 7.7e12,
              "collective_bytes_per_device": 0.0}
    for arch in ("qwen3-32b", "mamba2-2.7b"):
        for cell in ("train_4k", "decode_32k"):
            got = roofline.roofline_terms(parsed, 1, registry.get(arch),
                                          SHAPES[cell]).to_dict()
            want = ref.roofline.roofline_terms(
                parsed, 1, ref.registry.get(arch),
                ref.configs.SHAPES[cell]).to_dict()
            assert got == want


# -- partitioning -------------------------------------------------------------

class FakeMesh:            # tests/test_components.py's
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 4}


def test_partitioning_tables_equal_reference(ref):
    rp = ref.partitioning
    assert pt.DEFAULT_RULES == rp.DEFAULT_RULES
    assert pt.FSDP_RULES == rp.FSDP_RULES
    assert set(pt.PROFILES) == set(rp.PROFILES)
    assert pt.PARAM_RULES == rp.PARAM_RULES
    assert pt._EXTRA_LOGICAL == rp._EXTRA_LOGICAL


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_param_specs_under_fake_mesh(ref):
    params = {"embed": {"tok": _meta(64, 32)},
              "stack": [{"attn": {"wq": {"w": _meta(4, 32, 64)}}}],
              "head": _meta(32, 64)}
    pt._CTX.mesh = FakeMesh()
    pt._CTX.rules = dict(pt.DEFAULT_RULES)
    try:
        specs = pt.param_specs(params)
        assert specs["embed"]["tok"] == ("model", None)
        assert specs["stack"][0]["attn"]["wq"]["w"] == (None, "data",
                                                         "model")
        assert specs["head"] == (None, "model")
        assert pt.axis_size("heads") == 4 and pt.axis_size("batch") == 2
    finally:
        pt._CTX.mesh = None


def _at(t, path):
    for p in path:
        t = t[p]
    return t


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "whisper-small"])
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_param_specs_equal_reference_on_a_model(ref, arch, profile):
    """Every leaf of a reduced model's params (MLA, MoE, Mamba, enc-dec)
    under both profiles: the reference's spec as a tuple."""
    jcfg, cfg = _cfgs(ref, arch)
    jparams = jax.eval_shape(lambda k: ref.api.init(k, jcfg),
                             jax.random.PRNGKey(0))
    from repro_torch.models import api
    params = api.init(streams.meta_generator(), cfg)
    rp = ref.partitioning
    with rp.use_mesh(FakeMesh(), profile=profile):
        want = rp.param_specs(jparams)
    with pt.use_mesh(FakeMesh(), profile=profile):
        got = pt.param_specs(params)
    flat = tree.flatten_with_path(params)
    wflat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, rp.P))[0]
    assert len(flat) == len(wflat)
    for (path, _), (jpath, spec) in zip(flat, wflat):
        assert _at(got, path) == tuple(spec), path


def test_partitioning_places_nothing():
    x = torch.ones(4, 6)
    assert pt.shard(x, "batch", "ff") is x
    assert pt.sharding("batch") is None
    assert pt.named_shardings({"w": x}) is None
    assert pt.spmd_client_axes(4) == ()
    assert pt.active_mesh() is None and pt.axis_size("heads") == 1
    with pt.use_mesh(mesh.make_host_mesh(device="cpu"),
                     profile="fsdp") as m:
        assert pt.active_mesh() is m
        assert pt.axis_size("batch") == pt.axis_size("heads") == 1
        assert pt.spec("batch", None, "heads") == (("data", "model"), None,
                                                   None)
        with pt.exclude_axes(("data",)):
            assert pt.spec("batch") == (("model",),)
    assert pt.active_mesh() is None


# -- the counter against the reference's HLO parse ----------------------------

def _ref_parse(ref, fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    assert " dot(" in text          # the products stay dots on the CPU
    return ref.hlo.report(text)["parsed_flops_per_device"]


def _count(step, args) -> float:
    return hlo_analysis.analyze(step, *args)[0].flops


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_flops_match_reference_parse(ref, arch):
    jcfg, cfg = _cfgs(ref, arch)
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    if jcfg.encdec:
        batch["frames"] = jnp.zeros((B, jcfg.enc_seq, jcfg.d_model))
    want = _ref_parse(ref, lambda p, b: ref.api.prefill(p, b, jcfg, cap=S),
                      ref.api.init(jax.random.PRNGKey(0), jcfg), batch)
    got = _count(*dryrun.build_prefill(cfg, ShapeCfg("p", S, B, "prefill"),
                                       None))
    assert abs(got - want) <= PARSE_RTOL * want, (got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_flops_match_reference_parse(ref, arch):
    """One fused CPSL step of K clients (cut 1, SGD; remat is off in the
    reduced configs), forward and backward."""
    jcfg, cfg = _cfgs(ref, arch)
    rc = ref.cpsl.CPSL(ref.splitting.make_split_model(jcfg, 1),
                       ref.configs.CPSLConfig(cut_layer=1, cluster_size=K,
                                              batch_per_device=B))
    batch = {"tokens": jnp.zeros((K, B, S), jnp.int32),
             "labels": jnp.zeros((K, B, S), jnp.int32)}
    if jcfg.encdec:
        batch["frames"] = jnp.zeros((K, B, jcfg.enc_seq, jcfg.d_model))
    want = _ref_parse(ref, rc.fused_step_impl,
                      rc.init_state(jax.random.PRNGKey(0)), batch)
    got = _count(*dryrun.build_train(
        cfg, ShapeCfg("t", S, K * B, "train"), None, 1, K,
        ccfg_over=["optimizer=sgd"]))
    assert abs(got - want) <= PARSE_RTOL * want, (got, want)


# -- the counter: meta against the CPU ----------------------------------------

def _build(kind, cfg, device):
    if kind == "train":
        return dryrun.build_train(cfg, ShapeCfg("t", S, K * B, "train"),
                                  None, 1, K, device=device)
    if kind == "prefill":
        return dryrun.build_prefill(cfg, ShapeCfg("p", S, B, "prefill"),
                                    None, device=device)
    return dryrun.build_decode(cfg, ShapeCfg("d", S, B, "decode"), None,
                               False, device=device)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_cpu_count(arch, kind):
    """The same step on ``meta`` (shapes only) and on the CPU: the same op
    sequence, so the same FLOPs, bytes and live storage."""
    cfg = registry.reduce_for_smoke(registry.get(arch))
    stats = {}
    for device in ("meta", "cpu"):
        step, args = _build(kind, cfg, device)
        stats[device], out = hlo_analysis.analyze(step, *args)
        leaves = [t for t in jax.tree.leaves(out, is_leaf=torch.is_tensor)
                  if torch.is_tensor(t)]
        assert {t.device.type for t in leaves} == {device}
    m, c = stats["meta"], stats["cpu"]
    assert m.flops > 0 and m.hbm_bytes > 0
    for key in ("flops", "hbm_bytes", "n_ops", "argument_bytes",
                "output_bytes", "alias_bytes", "peak_bytes"):
        assert getattr(m, key) == getattr(c, key), key
    assert dict(m.custom_calls) == dict(c.custom_calls) == {}
    assert hlo_analysis.report(m) == hlo_analysis.report(c)
    assert hlo_analysis.report(m)["collectives_by_kind"] == {}


def test_counter_counts_products_views_and_memory():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    stats, out = hlo_analysis.analyze(lambda x, y: (x @ y).t() + 1, a, b)
    assert stats.flops == 2 * 8 * 16 * 4
    # mm reads a and b and writes (8, 4); add reads and writes (4, 8); t
    # is a view
    assert stats.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4 + 2 * 32)
    assert stats.argument_bytes == 4 * (8 * 16 + 16 * 4)
    assert stats.output_bytes == 4 * 32 and stats.alias_bytes == 0
    assert stats.peak_bytes == stats.argument_bytes + 2 * 4 * 32


# -- the kernels' meta paths --------------------------------------------------

def test_flash_attention_meta_path_counts_one_custom_call():
    q = torch.empty((8, 32, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((4, 48, 64), dtype=torch.bfloat16, device="meta")
    with telemetry.LaunchCounter() as launched:
        stats, out = hlo_analysis.analyze(
            lambda q, k, v: fa_kernel.flash_attention_flat(
                q, k, v, causal=False, kv_repeat=2), q, kv, kv)
    assert (out.shape, out.dtype, out.device.type) == (
        q.shape, q.dtype, "meta")
    assert dict(stats.custom_calls) == {"flash_attention": 1}
    assert stats.flops == 0
    assert stats.hbm_bytes == 2 * (2 * 8 * 32 * 64 + 2 * 4 * 48 * 64)
    assert launched["flash_attention"] == 0
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_flat(
            torch.empty((2, 4, 24), device="meta"),
            torch.empty((2, 4, 24), device="meta"),
            torch.empty((2, 4, 24), device="meta"))


def test_flash_attention_function_on_meta_trains():
    """The autograd.Function on meta: the forward is the kernel's meta
    path (one custom call), the backward the plain recomputation."""
    q = torch.empty((1, S, 2, 2, 64), device="meta", requires_grad=True)
    k = torch.empty((1, S, 2, 64), device="meta", requires_grad=True)
    v = torch.empty((1, S, 2, 64), device="meta", requires_grad=True)

    def step(q, k, v):
        out = fa_ops.flash_attention(q, k, v, True)
        return torch.autograd.grad(out.sum(), (q, k, v))

    stats, grads = hlo_analysis.analyze(step, q, k, v)
    assert dict(stats.custom_calls) == {"flash_attention": 1}
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert stats.flops > 0              # the backward's products


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_path_counts_one_custom_call(dtype):
    Bt, L, H, P, G, N = 2, 64, 4, 32, 1, 16
    x = torch.empty((Bt, L, H, P), dtype=dtype, device="meta")
    dt = torch.empty((Bt, L, H), device="meta")
    A = torch.empty((H,), device="meta")
    Bm = torch.empty((Bt, L, G, N), dtype=dtype, device="meta")
    with telemetry.LaunchCounter() as launched:
        stats, (y, hT) = hlo_analysis.analyze(
            lambda *a: ssd_kernel.ssd_grouped(*a, chunk=16), x, dt, A, Bm,
            Bm)
    assert (y.shape, y.dtype) == (x.shape, dtype)
    assert (hT.shape, hT.dtype) == ((Bt, H, N, P), torch.float32)
    assert dict(stats.custom_calls) == {"ssd": 1}
    assert stats.flops == 0
    e = x.element_size()
    assert stats.hbm_bytes == (2 * x.numel() * e + 4 * dt.numel()
                               + 4 * H + 2 * Bm.numel() * e
                               + 4 * Bt * H * N * P)
    assert launched["ssd"] == 0


# -- the dry run --------------------------------------------------------------

@pytest.fixture
def reduced(monkeypatch):
    """run_cell on the reduced configs and small cells."""
    get = registry.get
    monkeypatch.setattr(registry, "get",
                        lambda a: registry.reduce_for_smoke(get(a)))
    for name, shape in SHAPES.items():
        monkeypatch.setitem(SHAPES, name, ShapeCfg(
            name, S, K * B if shape.kind == "train" else B, shape.kind))


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_records_every_kind(ref, reduced, tmp_path, arch):
    """Every cell of the arch (train, prefill, decode, long_500k) through
    the kernels' meta paths; cut 1 (the reduced mamba2 has two layers,
    whisper two encoder layers). The reduced MLA's head dim, 16 + 8, is
    no kernel head dim: deepseek's attention stays chunked."""
    kernel = [] if arch == "deepseek-v2-lite-16b" else ["attn_impl=pallas"]
    for cell in registry.cells(arch):
        rec = dryrun.run_cell(arch, cell, "h100", str(tmp_path), cut=1,
                              cluster_size=K,
                              overrides=kernel + ["ssd_impl=pallas"])
        assert REF_RECORD_KEYS <= set(rec)
        assert rec["n_devices"] == 1 and rec["compile_s"] == 0.0
        assert "not applicable" in rec["xla_cost"]["error"]
        mem = rec["memory"]
        assert mem["peak_bytes_per_device"] == (
            mem["argument_bytes_per_device"] + mem["output_bytes_per_device"]
            + mem["temp_bytes_per_device"] - mem["alias_bytes_per_device"])
        assert mem["peak_bytes_per_device"] > mem["argument_bytes_per_device"]
        jshape = ref.configs.ShapeCfg(cell, S, SHAPES[cell].global_batch,
                                      SHAPES[cell].kind)
        jcfg = ref.registry.reduce_for_smoke(ref.registry.get(arch))
        assert rec["roofline"]["model_flops"] == \
            ref.roofline.model_flops(jcfg, jshape)
        assert rec["parsed"]["collective_bytes_per_device"] == 0
        fn = tmp_path / f"{arch}__{cell}__h100.json"
        assert json.loads(fn.read_text())["cell"] == cell
        if SHAPES[cell].kind != "decode" and arch != "deepseek-v2-lite-16b":
            assert rec["custom_calls"], cell     # the kernels' meta paths


def test_dryrun_refuses_the_tpu_meshes(reduced, tmp_path, capsys):
    for name in ("pod1", "pod2", "tiny"):
        with pytest.raises(ValueError, match="one card has no pod"):
            dryrun.run_cell("gemma2-2b", "prefill_32k", name, str(tmp_path))
        with pytest.raises(SystemExit, match="one card has no pod"):
            dryrun.main(["--arch", "gemma2-2b", "--cell", "prefill_32k",
                         "--mesh", name, "--device", "cpu"])
    dryrun.main(["--arch", "gemma2-2b", "--cell", "prefill_32k",
                 "--device", "cpu", "--out", str(tmp_path), "--tag", "t"])
    assert "[OK] gemma2-2b" in capsys.readouterr().out
    assert (tmp_path / "gemma2-2b__prefill_32k__h100__t.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.main(["--arch", "gemma2-2b", "--cell", "prefill_32k"])


def test_best_remat_group_and_defaults_equal_reference():
    # the reference's dryrun is never imported (it sets XLA_FLAGS); its
    # rule is restated here
    for n in range(1, 70):
        divs = [d for d in range(1, n + 1) if n % d == 0]
        want = min(divs, key=lambda d: (abs(d - math.sqrt(n)), d))
        assert dryrun.best_remat_group(n) == want
    assert dryrun.default_cut(registry.get("whisper-small")) == 2
    assert dryrun.default_cut(registry.get("qwen3-32b")) == 2
    assert dryrun.DEFAULT_MICROBATCHES == {}


def test_meta_state_has_the_card_state_layout():
    """build_train on meta gives the state tree init_state gives on a real
    device: same leaves, shapes and dtypes."""
    cfg = registry.reduce_for_smoke(registry.get("gemma2-2b"))
    (_, (ms, mb)), (_, (cs, cb)) = (
        dryrun.build_train(cfg, ShapeCfg("t", S, K * B, "train"), None, 1, K,
                           device=d) for d in ("meta", "cpu"))
    for a, b in zip(tree.flatten_with_path((ms, mb)),
                    tree.flatten_with_path((cs, cb))):
        assert a[0] == b[0]
        assert (a[1].shape, a[1].dtype, a[1].device.type) == (
            b[1].shape, b[1].dtype, "meta")
