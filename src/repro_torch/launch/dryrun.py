"""One-card dry run (the port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell, build the corresponding step
on the ``meta`` device (shapes and dtypes, no storage: the counterpart of
``jax.eval_shape``, so full-size params never appear on the host), run it
once under ``launch.hlo_analysis``'s op counter, and record:
  - the memory: argument, output and alias bytes and the peak of live
    storage over the step (does the cell fit one card's 80 GB?),
  - the counted FLOPs and HBM bytes (``parsed``),
  - the three roofline terms + MODEL_FLOPS ratio (``launch.roofline``).

The record has the reference's keys. ``lower_s`` is the meta trace's
seconds and ``compile_s`` 0.0 (nothing compiles); ``xla_cost`` carries the
reference's own error branch (eager PyTorch has no XLA cost analysis).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --cell train_4k \
        --mesh h100 --out experiments/dryrun
    python -m repro_torch.launch.dryrun --all --mesh h100
    python -m repro_torch.launch.dryrun --all --mesh h100 --device cpu
Variants override config fields, as in the reference:
    --override remat=False --override attn_impl=pallas --tag pallas

The only mesh is ``h100``, one card: the reference's ``pod1``, ``pod2``
and ``tiny`` are TPU meshes and fail with a message. Without a card the
entry point raises unless the caller passes ``--device cpu`` (the trace
runs on ``meta`` either way). The builders also build a step on a real
device (``device="cuda"``), with random weights from a seeded generator,
so that the same count can be held against the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import resolve_device, streams
from repro_torch.configs import registry
from repro_torch.configs.base import CPSLConfig, SHAPES, ModelConfig, ShapeCfg
from repro_torch.core import partitioning as pt
from repro_torch.core.cpsl import CPSL
from repro_torch.core.splitting import _split_cfgs, make_split_model
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whp

MESHES = ("h100",)

# realistic default cut layers (shallow per the paper's POOL1 finding;
# below the first MoE block where one exists so expert banks stay
# server-side)
DEFAULT_CUTS = {
    "deepseek-v2-lite-16b": 1, "phi3.5-moe-42b-a6.6b": 1,
    "jamba-v0.1-52b": 1, "whisper-small": 2,
}

# grad-accumulation splits (the reference's: none by default)
DEFAULT_MICROBATCHES = {}


def default_cut(cfg: ModelConfig) -> int:
    return DEFAULT_CUTS.get(cfg.name, 2)


def best_remat_group(n_periods: int) -> int:
    """Divisor of n_periods nearest sqrt(n_periods) (sqrt-remat)."""
    best, target = 1, math.sqrt(max(n_periods, 1))
    for d in range(1, n_periods + 1):
        if n_periods % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best


# --------------------------------------------------------------------------
# cell builders: return (step, args) on ``device``
# --------------------------------------------------------------------------

def _generators(device):
    """(params root, batch root), seed 0: ``meta`` roots build shapes
    only."""
    if torch.device(device).type == "meta":
        return streams.meta_generator(), streams.meta_generator()
    return (streams.model_generator(0, device),
            streams.sampler_generator(0, device))


def _tokens(gen, shape, cfg: ModelConfig):
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device=gen.device, dtype=torch.int32)


def _frames(gen, lead, cfg: ModelConfig):
    return torch.randn(tuple(lead) + (cfg.enc_seq, cfg.d_model),
                       generator=gen, device=gen.device).to(
        getattr(torch, cfg.dtype))


def build_train(cfg: ModelConfig, shape: ShapeCfg, mesh, cut: int,
                cluster_size: int, microbatches: int = 1, ccfg_over=None,
                device="meta"):
    """One CPSL cluster step (``fused_step_impl``, or
    ``protocol_step_impl`` with ``fused_step=False``): K = cluster_size
    clients of B = global_batch // K sequences each."""
    K = cluster_size
    B = shape.global_batch // K
    assert B >= 1, (shape.global_batch, K)
    ccfg = CPSLConfig(cut_layer=cut, cluster_size=K, batch_per_device=B,
                      optimizer="adamw_mixed", lr_device=1e-4,
                      lr_server=1e-4,
                      microbatches=min(microbatches, B))
    if ccfg_over:
        kw = {}
        for ov in ccfg_over:
            k_, v_ = ov.split("=", 1)
            cur = getattr(ccfg, k_)
            if isinstance(cur, bool):
                v_ = v_ in ("1", "true", "True")
            elif isinstance(cur, int):
                v_ = int(v_)
            elif isinstance(cur, float):
                v_ = float(v_)
            kw[k_] = v_
        ccfg = dataclasses.replace(ccfg, **kw)
    cpsl = CPSL(make_split_model(cfg, cut), ccfg)
    pgen, bgen = _generators(device)
    state = cpsl.init_state(pgen)
    batch = {"tokens": _tokens(bgen, (K, B, shape.seq_len), cfg),
             "labels": _tokens(bgen, (K, B, shape.seq_len), cfg)}
    if cfg.encdec:
        batch["frames"] = _frames(bgen, (K, B), cfg)
    step_impl = (cpsl.fused_step_impl if ccfg.fused_step
                 else cpsl.protocol_step_impl)

    def step(state, batch):
        return step_impl(state, batch)

    return step, (state, batch)


def build_prefill(cfg: ModelConfig, shape: ShapeCfg, mesh, device="meta"):
    """``api.prefill`` of global_batch prompts of seq_len tokens into a
    cache of seq_len, without grad."""
    pgen, bgen = _generators(device)
    params = api.init(pgen, cfg)
    batch = {"tokens": _tokens(bgen, (shape.global_batch, shape.seq_len),
                               cfg)}
    if cfg.encdec:
        batch["frames"] = _frames(bgen, (shape.global_batch,), cfg)

    @torch.no_grad()
    def step(params, batch):
        return api.prefill(params, batch, cfg, cap=shape.seq_len)

    return step, (params, batch)


def build_decode(cfg: ModelConfig, shape: ShapeCfg, mesh, long_ctx: bool,
                 device="meta"):
    """One ``api.decode_step`` of global_batch sequences at the last
    position of a seq_len cache. The reference's ``long_ctx`` cache layout
    shards the sequence over every chip; one card has one layout, so
    ``long_ctx`` builds the same cache."""
    gb, S = shape.global_batch, shape.seq_len
    pgen, bgen = _generators(device)
    params = api.init(pgen, cfg)
    if cfg.encdec:
        with torch.no_grad():
            b = {"tokens": torch.zeros((gb, 8), dtype=torch.int32,
                                       device=pgen.device),
                 "frames": torch.zeros((gb, cfg.enc_seq, cfg.d_model),
                                       dtype=getattr(torch, cfg.dtype),
                                       device=pgen.device)}
            cache = whp.prefill(params, b, cfg, cap=S)[1]
    else:
        cache = tfm.init_cache(cfg, gb, S, pgen.device)
    tokens = _tokens(bgen, (gb,), cfg)

    @torch.no_grad()
    def step(params, cache, tokens):
        return api.decode_step(params, cache, tokens, S - 1, cfg)

    return step, (params, cache, tokens)


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

def apply_overrides(cfg: ModelConfig, overrides):
    kw = {}
    for ov in overrides or []:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v in ("1", "true", "True")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return cfg.replace(**kw) if kw else cfg


def _check_mesh(mesh_name: str):
    if mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r}: one card has no pod (the "
                         "reference's pod1, pod2 and tiny are TPU meshes); "
                         f"the port's only mesh is {MESHES[0]!r}")


def run_cell(arch: str, cell: str, mesh_name: str, out_dir: str,
             overrides=None, tag: str = "", cut: int = None,
             cluster_size: int = None, profile: str = None,
             ccfg_over=None) -> dict:
    """Trace one cell on ``meta`` and write its record to ``out_dir``."""
    t_start = time.time()
    _check_mesh(mesh_name)
    cfg = apply_overrides(registry.get(arch), overrides)
    shape = SHAPES[cell]
    mesh = make_host_mesh(device="cpu")      # one card; nothing placed
    n_dev = mesh.size

    if profile is None:
        # the reference's defaults (pure FSDP for train, TP for serving);
        # on one card the profile places nothing
        profile = "fsdp" if shape.kind == "train" else "tp"
    with pt.use_mesh(mesh, profile=profile):
        if shape.kind == "train":
            K = cluster_size or 16
            if cfg.loss_chunk == 0:
                cfg = cfg.replace(loss_chunk=2048)   # chunked CE (prod)
            if cfg.param_dtype == "float32":
                cfg = cfg.replace(param_dtype="bfloat16")
            v = cut or default_cut(cfg)
            explicit_rg = any(o.startswith("remat_group=")
                              for o in (overrides or []))
            if cfg.remat_group == 1 and cfg.pattern and not cfg.encdec \
                    and not explicit_rg:
                _, srv_cfg = _split_cfgs(cfg, v)
                cfg = cfg.replace(remat_group=best_remat_group(
                    max(srv_cfg.n_periods, 1)))
            step, args = build_train(
                cfg, shape, mesh, v, K,
                microbatches=DEFAULT_MICROBATCHES.get(arch, 1),
                ccfg_over=ccfg_over)
        elif shape.kind == "prefill":
            step, args = build_prefill(cfg, shape, mesh)
        else:
            step, args = build_decode(cfg, shape, mesh,
                                      long_ctx=cell == "long_500k")
        t0 = time.time()
        stats, _ = hlo_analysis.analyze(step, *args)
        t_lower = time.time() - t0

    rec = {"arch": arch, "cell": cell, "mesh": mesh_name, "tag": tag,
           "profile": profile, "ccfg": list(ccfg_over or []),
           "n_devices": n_dev, "lower_s": round(t_lower, 2),
           "compile_s": 0.0, "overrides": list(overrides or [])}
    rec["memory"] = {
        "argument_bytes_per_device": stats.argument_bytes,
        "output_bytes_per_device": stats.output_bytes,
        "temp_bytes_per_device": (stats.peak_bytes - stats.argument_bytes
                                  - stats.output_bytes
                                  + stats.alias_bytes),
        "alias_bytes_per_device": stats.alias_bytes,
        "peak_bytes_per_device": stats.peak_bytes,
    }
    rec["xla_cost"] = {"error": "not applicable: eager PyTorch has no XLA "
                                "cost analysis"}
    parsed = hlo_analysis.report(stats)
    rec["parsed"] = parsed
    rec["custom_calls"] = dict(stats.custom_calls)
    rl = roofline_terms(parsed, n_dev, cfg, shape)
    rec["roofline"] = rl.to_dict()
    rec["total_s"] = round(time.time() - t_start, 2)

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = os.path.join(out_dir, f"{arch}__{cell}__{mesh_name}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="h100",
                    help="h100 (one card); the reference's pod1, pod2 and "
                         "tiny are refused")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--tag", default="")
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--cluster-size", type=int, default=None)
    ap.add_argument("--profile", default=None, choices=["tp", "fsdp"])
    ap.add_argument("--ccfg", action="append", default=[],
                    help="CPSLConfig overrides, e.g. fused_step=False")
    ap.add_argument("--device", default="cuda",
                    help="the card the roofline is for; 'cpu' traces "
                         "without one (the trace runs on meta)")
    args = ap.parse_args(argv)
    try:
        _check_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e))
    resolve_device(args.device)

    cells = []
    if args.all:
        for arch in registry.list_archs():
            for cell in registry.cells(arch):
                cells.append((arch, cell))
    else:
        if not (args.arch and args.cell):
            ap.error("pass --arch and --cell, or --all")
        cells = [(args.arch, args.cell)]

    failures = []
    for arch, cell in cells:
        try:
            rec = run_cell(arch, cell, args.mesh, args.out,
                           overrides=args.override, tag=args.tag,
                           cut=args.cut, cluster_size=args.cluster_size,
                           profile=args.profile, ccfg_over=args.ccfg)
            rl, mem = rec["roofline"], rec["memory"]
            print(f"[OK] {arch:24s} {cell:12s} {args.mesh}: "
                  f"trace {rec['lower_s']}s "
                  f"mem/dev {mem['peak_bytes_per_device']/1e9:.2f}GB "
                  f"compute {rl['compute_s']*1e3:.2f}ms "
                  f"mem {rl['memory_s']*1e3:.2f}ms "
                  f"coll {rl['collective_s']*1e3:.2f}ms "
                  f"-> {rl['bottleneck']}", flush=True)
        except Exception as e:
            failures.append((arch, cell, str(e)))
            print(f"[FAIL] {arch} {cell}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed")


if __name__ == "__main__":
    main()
