#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero without them, and when run
from a directory that lacks the repository's ``src/``. Phases, none of whose
failures is caught:

1. device: the card's name and power limit; builds every kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. kernels: each kernel against its plain PyTorch version on the card, over
   a sweep of small cases and at the shapes the serving paths give it,
   timed with CUDA events beside the plain version, a PyTorch library call
   where one computes the same function, and the card's bound:
   - flash attention (K1) at gemma2-2b prefill: B*G = 16 kv heads, R = 2,
     S = 5120, D = 256, bf16, softcap 50, window 4096 and 0;
   - the SSD scan (K2) at mamba2-2.7b prefill: BH = 4 * 80 heads,
     S = 8192, P = 64, N = 128, chunk 256, bf16.
3. serve gemma2-2b at full width (random weights from a seeded generator)
   through ``ServeEngine.generate`` with batch 4, a 5120-token prompt and 16
   greedy steps, with the kernels' launch counts read around that run;
   prefill and decode times with a torch.profiler breakdown of one call
   each; the prefill logits against the naive-attention path; a reduced
   gemma2 in float32 whose tokens must match the naive path exactly.
4. serve mamba2-2.7b at full width the same way, with batch 4, an
   8192-token prompt and 16 greedy steps; the prefill logits against the
   chunked SSD path; a reduced mamba2 in float32 whose tokens must match
   the scan path exactly.

Prints one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 without them,
# HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

F32_TOL, BF16_TOL = 2e-5, 3e-2     # tests/test_kernels.py: kernel vs oracle
SSD_F32_TOL, SSD_BF16_TOL = 5e-5, 5e-2   # tests/test_kernels.py: SSD
LOGITS_TOL = 0.15                  # tests/test_kernels.py: bf16 model path

BATCH, PROMPT, STEPS = 4, 5120, 16
MAMBA_PROMPT = 8192                # 32 chunks of 256


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def device_phase() -> dict:
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    seconds = _build.build()
    log(f"kernels built in {seconds:.1f} s: {', '.join(_build.sources())}")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                log(f"  {name}: {line.strip()}")
    return {"nvidia_smi": smi, "build_s": seconds}


# --------------------------------------------------------------------------
# 2. kernels
# --------------------------------------------------------------------------

def _visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    n = 0
    for i in range(Sq):
        qpos = q_offset + i
        hi = min(Skv, qpos + 1) if causal else Skv
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def _attention_bound_ms(BHq, BHkv, Sq, Skv, D, dtype, causal, window):
    import torch
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    size = 2 if name == "bfloat16" else 4
    flops = 4 * D * _visible_pairs(Sq, Skv, causal, window) * BHq
    nbytes = size * D * (2 * BHq * Sq + 2 * BHkv * Skv)
    t_ops = flops / PEAK_FLOPS[name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _flash_inputs(gen, BHkv, R, Sq, Skv, D, dtype):
    import torch
    def mk(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return mk(BHkv * R, Sq, D), mk(BHkv, Skv, D), mk(BHkv, Skv, D)


def flash_sweep() -> dict:
    """K1 against attention_ref over small cases: f32/bf16, D, causal with
    and without a window, softcap, q_offset > 0, GQA and ragged lengths."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for D in (16, 32, 64, 128, 256):
            for window in (0, 64):
                for cap in (0.0, 50.0):
                    for (BHkv, R, Sq, Skv, causal, q_offset) in (
                            (2, 2, 200, 200, True, 0),      # ragged, GQA
                            (3, 1, 72, 200, True, 128),     # q_offset > 0
                            (2, 1, 256, 256, window == 0, 0)):
                        q, k, v = _flash_inputs(gen, BHkv, R, Sq, Skv, D,
                                                dtype)
                        kw = dict(causal=causal, window=window, softcap=cap,
                                  q_offset=q_offset, kv_repeat=R)
                        got = flash_attention_flat(q, k, v, **kw)
                        torch.cuda.synchronize()
                        want = attention_ref(q, k, v, **kw)
                        err = (got.float() - want.float()).abs().max().item()
                        if not err < tol:
                            raise AssertionError(
                                f"flash_attention {dtype} D={D} {kw} "
                                f"Sq={Sq} Skv={Skv}: max abs err {err} "
                                f">= {tol}")
                        name = str(dtype).split(".")[1]
                        worst[name] = max(worst[name], err)
                        n += 1
    log(f"flash_attention sweep: {n} cases, max abs err {worst}")
    return worst


def flash_slice_shapes() -> list:
    """K1 at the gemma2-2b prefill shapes: error, kernel/plain/library times
    and the bound. library_ms is scaled_dot_product_attention on the same
    shapes WITHOUT the softcap (no single torch call softcaps); the port
    never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    G, R, D, S = 4, 2, 256, PROMPT
    rows = []
    for window in (4096, 0):
        q, k, v = _flash_inputs(gen, BATCH * G, R, S, S, D, torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=50.0, q_offset=0,
                  kv_repeat=R)
        got = flash_attention_flat(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        del want
        if not err < BF16_TOL:
            raise AssertionError(f"flash_attention slice shape window="
                                 f"{window}: max abs err {err}")
        ms = time_ms(lambda: flash_attention_flat(q, k, v, **kw), 5)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), 2)
        q4 = q.view(BATCH, G * R, S, D)
        k4, v4 = k.view(BATCH, G, S, D), v.view(BATCH, G, S, D)
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q4, k4, v4, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q4, k4, v4, is_causal=True, enable_gqa=True)
        library_ms = time_ms(lib, 5)
        bound_ms, bound_by = _attention_bound_ms(
            BATCH * G * R, BATCH * G, S, S, D, torch.bfloat16, True, window)
        row = {"window": window, "shape": f"q ({BATCH * G * R},{S},{D}) "
               f"kv ({BATCH * G},{S},{D}) bf16 softcap 50 causal",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        log(f"flash_attention window={window}: " + json.dumps(row))
        rows.append(row)
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


# (BH, S, P, N, chunk, dtype name, large |A| dt)
SSD_CASES = [
    # the cases of tests/test_kernels.py::SSD_CASES
    (3, 256, 64, 32, 64, "float32", False),
    (2, 128, 32, 128, 128, "float32", False),
    (4, 64, 16, 16, 32, "float32", False),
    (2, 128, 64, 64, 64, "bfloat16", False),
    (1, 512, 32, 32, 128, "float32", False),
    # mamba2-2.7b's N, P and chunk at small BH
    (2, 512, 64, 128, 256, "float32", False),
    (2, 512, 64, 128, 256, "bfloat16", False),
    # ragged S: the chunk halves to 8; S < chunk (Q = 100); odd S (Q = 1)
    (2, 200, 32, 32, 64, "float32", False),
    (2, 100, 64, 128, 256, "bfloat16", False),
    (1, 129, 16, 16, 64, "float32", False),
    # exp(cum_i - cum_j) overflows above the diagonal: no NaN may leak
    (2, 256, 64, 128, 256, "float32", True),
    (2, 256, 64, 128, 256, "bfloat16", True),
]


def _ssd_inputs(gen, BH, S, P, N, dtype, big_decay=False):
    """tests/test_kernels.py's inputs, with B and C scaled by
    0.5 * min(1, 32 / N) so that |y| stays below ~8 at any N: the absolute
    limits then measure the kernel (5e-5 is a few f32 ulps; 5e-2 is under
    one bf16 ulp only below 8)."""
    import torch
    import torch.nn.functional as F
    def mk(*shape):
        return torch.randn(shape, device="cuda", generator=gen)
    x = mk(BH, S, P).to(dtype)
    dt = F.softplus(mk(BH, S) + (1.0 if big_decay else -1.0))
    A = (torch.full((BH,), -16.0, device="cuda") if big_decay
         else -torch.exp(mk(BH) * 0.3))
    scale = 0.5 * min(1.0, 32 / N)
    return x, dt, A, (mk(BH, S, N) * scale).to(dtype), \
        (mk(BH, S, N) * scale).to(dtype)


def _ssd_err(got, want) -> float:
    return max((got[0].float() - want[0].float()).abs().max().item(),
               (got[1] - want[1]).abs().max().item())


def ssd_sweep() -> dict:
    """K2 against ssd_chunked_ref (same chunks) and, where S <= 512,
    ssd_scan_ref: f32/bf16, the reference's cases, the model's N/P/chunk,
    ragged S and large decays."""
    import torch
    from repro_torch.kernels.ssd.kernel import chunk_len, ssd_flat
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (BH, S, P, N, chunk, name, big) in SSD_CASES:
        args = _ssd_inputs(gen, BH, S, P, N, getattr(torch, name), big)
        got = ssd_flat(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.isfinite(got[0].float()).all()
                and torch.isfinite(got[1]).all()):
            raise AssertionError(f"ssd {name} BH={BH} S={S} P={P} N={N} "
                                 f"chunk={chunk}: non-finite output")
        plains = [ssd_chunked_ref(*args, chunk=chunk_len(S, chunk))]
        if S <= 512:
            plains.append(ssd_scan_ref(*args))
        tol = SSD_F32_TOL if name == "float32" else SSD_BF16_TOL
        for want in plains:
            err = _ssd_err(got, want)
            if not err < tol:
                raise AssertionError(
                    f"ssd {name} BH={BH} S={S} P={P} N={N} chunk={chunk} "
                    f"large decay {big}: max abs err {err} >= {tol}")
            worst[name] = max(worst[name], err)
    log(f"ssd sweep: {len(SSD_CASES)} cases, max abs err {worst}")
    return worst


def _ssd_bound_ms(BH, S, P, N, Q, dtype):
    """Each input read once, each output written once; the operations the
    chunked form needs: per chunk, C B^T and M x over the Q(Q+1)/2 visible
    (i, j) pairs, C h and the state update over Q*N*P each."""
    import torch
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    size = 2 if name == "bfloat16" else 4
    nbytes = size * (2 * BH * S * P + 2 * BH * S * N) \
        + 4 * (BH * S + BH + BH * N * P)
    pairs = Q * (Q + 1) // 2
    flops = BH * (S // Q) * (2 * pairs * (N + P) + 4 * Q * N * P)
    t_ops = flops / PEAK_FLOPS[name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            {"bytes": nbytes, "flops": flops, "bytes_ms": 1e3 * t_bytes,
             "operations_ms": 1e3 * t_ops})


def ssd_slice_shape() -> dict:
    """K2 at the mamba2-2.7b prefill shape: error, kernel and plain times
    and the bound. No single PyTorch call computes the SSD scan, so there
    is no library time."""
    import torch
    from repro_torch.kernels.ssd.kernel import chunk_len, ssd_flat
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    BH, S, P, N, chunk = BATCH * 80, MAMBA_PROMPT, 64, 128, 256
    args = _ssd_inputs(gen, BH, S, P, N, torch.bfloat16)
    Q = chunk_len(S, chunk)
    got = ssd_flat(*args, chunk=chunk)
    torch.cuda.synchronize()
    err = _ssd_err(got, ssd_chunked_ref(*args, chunk=Q))
    if not err < SSD_BF16_TOL:
        raise AssertionError(f"ssd slice shape: max abs err {err}")
    ms = time_ms(lambda: ssd_flat(*args, chunk=chunk), 5)
    plain_ms = time_ms(lambda: ssd_chunked_ref(*args, chunk=Q), 2)
    bound_ms, bound_by, terms = _ssd_bound_ms(BH, S, P, N, Q, torch.bfloat16)
    row = {"shape": f"x ({BH},{S},{P}) B, C ({BH},{S},{N}) bf16, "
           f"chunk {Q}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, **terms}
    log("ssd slice shape: " + json.dumps(row))
    del args, got
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# 3. and 4. serve
# --------------------------------------------------------------------------

def small_path_check(cfg, plain_cfg, label: str):
    """A reduced model in float32 on the card: the kernel path (``cfg``)
    against the plain path, tokens identical and prefill logits within
    1e-4."""
    import torch
    from repro_torch import streams
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine
    params = api.init(streams.model_generator(0, "cuda"), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda",
                         generator=streams.sampler_generator(1, "cuda"))
    outs, logits = [], []
    for c in (cfg, plain_cfg):
        eng = ServeEngine(c, params, cap=48, device="cuda")
        logits.append(eng.prefill({"tokens": toks})[0])
        outs.append(eng.generate({"tokens": toks}, steps=8))
    err = (logits[0] - logits[1]).abs().max().item()
    if not (err < 1e-4 and torch.equal(outs[0], outs[1])):
        raise AssertionError(f"reduced {label} f32: kernel vs plain logits "
                             f"err {err}, tokens equal "
                             f"{torch.equal(outs[0], outs[1])}")
    log(f"reduced {label} f32 on the card: kernel vs plain logits max abs "
        f"err {err:.3g}, 8 greedy tokens identical")


def _kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    return {"flash_attention": fk, "ssd": sk}


def serve(cfg, plain_cfg, prompt: int, kernel: str) -> dict:
    """``cfg`` at full width through ``ServeEngine.generate`` (batch BATCH,
    ``prompt`` tokens, STEPS greedy steps), with every kernel's launch count
    set to 0 just before that run and read just after; ``kernel`` must have
    been launched once per layer. Then a prefill and decode breakdown, a
    profile of one call each, and the prefill logits against the plain
    path ``plain_cfg``."""
    import torch
    from repro_torch import streams
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    params = api.init(streams.model_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name} init: {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.2f} s")
    cap = prompt + STEPS
    eng = ServeEngine(cfg, params, cap=cap, device="cuda")
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (BATCH, prompt), device="cuda",
        generator=streams.sampler_generator(1, "cuda"))}
    eng.generate(batch, steps=2)                      # warm-up
    torch.cuda.synchronize()

    # the main path, with the kernels' counts read around it
    modules = _kernel_modules()
    for m in modules.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(batch, steps=STEPS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches[kernel] != cfg.n_layers:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times in "
                             f"one generate; expected {cfg.n_layers} (one "
                             f"per layer of the prefill)")
    if out.shape != (BATCH, STEPS) or out.dtype != torch.int32 or not (
            0 <= int(out.min()) and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"bad generate output {out.shape} {out.dtype}")

    # breakdown: prefill, then decode steps from its cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(STEPS - 1):
        step_logits, cache = eng.decode(cache, tok, prompt + i)
        tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / (STEPS - 1)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    profiles = {
        "prefill": device_profile(lambda: eng.prefill(batch)),
        "decode_step": device_profile(
            lambda: eng.decode(cache, tok, prompt + STEPS - 1))}
    del cache
    for name, prof in profiles.items():
        log(f"profile {cfg.name} {name}: " + json.dumps(prof))

    plain = ServeEngine(plain_cfg, params, cap=cap, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_plain, cache = plain.prefill(batch)
    torch.cuda.synchronize()
    plain_prefill_ms = 1e3 * (time.perf_counter() - t0)
    del cache
    err = (logits - logits_plain).abs().max().item()
    if not err <= LOGITS_TOL:
        raise AssertionError(f"{cfg.name} prefill logits: kernel vs plain "
                             f"path max abs err {err} > {LOGITS_TOL}")
    result = {
        "model": cfg.name, "batch": BATCH, "prompt": prompt,
        "steps": STEPS, "cap": cap, "launches_per_generate": launches,
        "generate_s": generate_s,
        "tokens_per_s": BATCH * STEPS / generate_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "plain_prefill_ms": plain_prefill_ms,
        "logits_max_abs_err_vs_plain": err, "peak_memory_gb": peak_gb,
        "device_busy_share": {k: v["busy_share"]
                              for k, v in profiles.items()},
        "first_row": out[0].tolist()}
    log("serve: " + json.dumps(result))
    del params, eng, plain
    torch.cuda.empty_cache()
    return result


def gemma_serve_phase() -> dict:
    from repro_torch.configs import registry
    from repro_torch.configs.base import LayerSpec
    small = registry.reduce_for_smoke(registry.get("gemma2-2b"))
    small = small.replace(dtype="float32", attn_impl="pallas",
                          pattern=(LayerSpec("attn", "dense", window=8),
                                   small.pattern[1]))
    small_path_check(small, small.replace(attn_impl="naive"), "gemma2")
    cfg = registry.get("gemma2-2b").replace(attn_impl="pallas")
    return serve(cfg, cfg.replace(attn_impl="naive"), PROMPT,
                 "flash_attention")


def mamba_serve_phase() -> dict:
    from repro_torch.configs import registry
    small = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype="float32", ssd_impl="pallas")
    small_path_check(small, small.replace(ssd_impl="scan"), "mamba2")
    cfg = registry.get("mamba2-2.7b").replace(ssd_impl="pallas")
    return serve(cfg, cfg.replace(ssd_impl="chunked"), MAMBA_PROMPT, "ssd")


def device_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: its host wall time, the
    device time summed over the kernels it ran (one stream, so the sum is
    the busy time), the busy share of the wall time, and the ``top``
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if "CUDA" in str(e.device_type)),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [[name[:80], ms] for name, ms in kernels[:top]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device_phase()
    sweep = flash_sweep()
    shapes = flash_slice_shapes()
    ssd_worst = ssd_sweep()
    ssd_row = ssd_slice_shape()
    gemma = gemma_serve_phase()
    mamba = mamba_serve_phase()

    def mean(key):
        return sum(r[key] for r in shapes) / len(shapes)

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": gemma["launches_per_generate"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": shapes[0]["bound_by"],
        "library_ms": mean("library_ms"),
        "per": "launch, mean of the local (window 4096) and global layer "
               "shapes, which gemma2-2b prefill launches 13 times each",
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "without softcap (no torch call softcaps)",
        "shapes": shapes, "sweep_max_abs_err": sweep}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:28",
        "launches": mamba["launches_per_generate"]["ssd"],
        "max_abs_err": ssd_row["max_abs_err"],
        "ms": ssd_row["ms"], "plain_ms": ssd_row["plain_ms"],
        "bound_ms": ssd_row["bound_ms"], "bound_by": ssd_row["bound_by"],
        "library_ms": None,
        "per": "launch at the mamba2-2.7b prefill shape, which prefill "
               "launches once per layer",
        "library_call": "none: no single PyTorch call computes the SSD scan",
        "shape": ssd_row["shape"], "sweep_max_abs_err": ssd_worst}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
