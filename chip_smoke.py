#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero without them, and when run
from a directory that lacks the repository's ``src/``. Phases, none of whose
failures is caught:

1. device: the card's name and power limit; builds every kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. kernels: K1's bf16 kernels as ptxas built them (registers, spill bytes
   and shared memory a block for each head dim; the phase fails if ptxas
   serialised a bf16 attention kernel's wgmma or one spills); then each
   kernel against its plain PyTorch version on the card, over a sweep of
   small cases and at the shapes the serving paths give it, timed with
   CUDA events beside the plain version, a PyTorch library call where one
   computes the same function, and the card's bound:
   - flash attention (K1) at gemma2-2b prefill: B*G = 16 kv heads, R = 2,
     S = 5120, D = 256, bf16, softcap 50, window 4096 and 0; at
     deepseek-v2-lite's MLA prefill, q = kv = (64, 4096, 192), and at
     phi3.5-moe's and jamba's, q (128, 4096, 128) over kv (32, 4096, 128),
     causal; at whisper-small's encoder, q = kv = (192, 1500, 64), and
     cross-attention, q (192, 64, 64) over kv (192, 1500, 64), non-causal;
     beside scaled_dot_product_attention (the same function);
   - the SSD scan (K2) at jamba's prefill shape: x (4, 4096, 128, 64), B,
     C (4, 4096, 1, 16), chunk 256, bf16;
   - the SSD scan (K2) at the shape mamba2-2.7b prefill gives it: x
     (4, 8192, 80, 64) and B, C (4, 8192, 1, 128) as strided views of one
     packed projection, chunk 256, bf16; at the flat per-head slice
     shape x (320, 8192, 64), B and C (320, 8192, 128); and at the model
     path's width with 8191 and 8190 tokens (chunks of 1 and 2 rows)
     against the sequential scan, with the call's peak memory.
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
5. moe_serve: deepseek-v2-lite-16b at full width and depth (27 layers,
   MLA prefill through K1 at D = 192), phi3.5-moe-42b (8 of 32 layers)
   and jamba-v0.1-52b (one 8-layer period: K1 once, K2 seven times) at
   full width, bf16 params, batch 4, a 4096-token prompt, 16 greedy
   steps, each through ``serve`` with the launches of each kernel
   expected from the layer kinds; the prefill logits held to the plain
   path under a routing-flip rule (``moe_routing_check``); a reduced f32
   model of each whose tokens must match the naive path exactly.
6. whisper_serve: a reduced f32 whisper at head dim 64 and 100 frames
   whose tokens must match the naive path exactly, then whisper-small at
   full width and depth (12 + 12 layers, d = 768, 12 heads of 64) through
   ``serve``: 16 clips of 1500 seeded random frame embeddings, a 64-token
   prompt, 16 greedy steps; K1 launched 12 + 2 * 12 = 36 times a
   generate (the encoder's self-attention, the decoder's self- and
   cross-attention at prefill), the prefill logits within 0.15 of the
   chunked path's.
7. train the paper's LeNet with CPSL (Alg. 1) through ``CPSLTrainer`` at
   the paper's configuration (30 devices, 6 clusters of 5, batch 16) on
   synthetic non-IID MNIST: SAA cut selection, then 8 rounds with Gibbs
   clustering, looped and fused. It launches no hand-written kernel (the
   reference's training path has no Pallas kernel); it checks fused
   against looped, the card against the CPU for one round, a fused round
   with no host sync, and that the loss falls.
8. fleet: the quickstart's second half on the same data and cut,
   through ``FleetRunner.run`` (``CPSL.run_fleet``, the replica axis
   batched): the quickstart's 4-replica fleet; the README's 9-replica
   grid (seeds 0-2 x cluster sizes 3, 5, 10, padded to 10 x 10, 20
   rounds) against each replica's solo ``run_training_fused``, a padded
   slot perturbed, the whole call under ``set_sync_debug_mode("error")``,
   timed and profiled; an 8-replica lr x seed grid; and the batched
   planner (``sim.batched``: SAA against the looped SAA, then 3 rounds of
   ``CPSLTrainer`` with ``resource_mgmt="gibbs-mc"``). It launches no
   hand-written kernel either.
9. lm_train: split-LM CPSL training (``CPSL.run_round``) at full width,
   2 clusters of 2 devices, 2 rounds, bf16 compute with remat:
   gemma2-2b (S = 5120) through K1 and mamba2-2.7b (S = 4096) through
   K2, full depth, the cut from SAA; whisper-small at full depth with
   the cut inside the encoder (SAA), 4 clips a device, a 448-token
   decoder context; deepseek-v2-lite-16b with bf16 params at 14 of its
   27 layers, v = 1, one 4096-token sequence a device. Each kernel's
   launches must equal ``_lm_launches_per_step`` a step (2 * (K*v +
   layers - v); whisper K*v + (12 - v) + 4 * 12) and the other's 0, the
   step losses must be finite (and fall with f32 params), every
   parameter leaf must be reached and, where some update is MOVE_ULPS
   ulp or more of its value, move in the first step, and one block of
   each kind must give the plain path's parameter gradients through the
   kernel's ``autograd.Function`` (f32 and bf16; a MoE block's plain
   path on the kernel path's routes); then ``launch/train.py --arch
   gemma2-2b --reduced`` through ``CPSLTrainer``.
10. sim: the wireless-dynamics simulator (``repro_torch.sim``), float64
   on the card: ``SimFleetRunner`` on bench_simfleet's two grids at the
   paper's N = C = 30, K = 5 (greedy and equal, 8 seeds x 150 slots;
   the proposed two-timescale controller, 8 seeds x 60 slots) and on
   fig. 7's 300 runs x 12 cuts, each episode's decisions against the
   port's looped NumPy ``run_reference`` and, for the bench grids, a CPU
   ``run``; ``SimEngine`` training LeNet at examples/dynamics_sim.py's
   setting, its trace recomputed. It launches no hand-written kernel.
11. rt: the CPSL deployment runtime (``repro_torch.rt``): 30 device
   worker processes, each its own CUDA context, and the server in this
   process over localhost sockets at the paper's configuration (6
   clusters of 5, B = 16, 2 rounds), bit-equal to ``loopback_reference``
   on the card; examples/rt_loopback.py's deployment with its fault
   round (device 3 dropped in round 1) and its crossval; the chaos drill
   (a worker and the server SIGKILLed, ``run_elastic`` resuming from the
   WAL) bit-equal to the fault-free reference. No hand-written kernel.
12. launch: the dry run, the roofline and the analysis
   (``repro_torch.launch``, ``repro_torch.analysis``): (a) the dry run's
   whole table (10 arches, 32 cells) traced on ``meta`` through the
   kernels' meta paths, in a process started after the kernels build
   and run beside the card phases: per cell the peak GB, whether it fits
   80 GB, the roofline terms, MODEL_FLOPS and the useful ratio; (b)
   gemma2-2b prefill (K1 26 times), mamba2-2.7b prefill (K2 64 times) and
   a gemma2-2b split training step, each built by the dry run's builders
   on ``meta`` and on the card under the same op counter: FLOPs and bytes
   equal, custom calls equal to the launches, the peak estimate against
   ``max_memory_allocated``, the step time against the roofline; (c)
   ``python -m repro_torch.analysis --check`` (JIT002 on the card) exits
   0.

Prints one ``{"moe_serve": {...}}`` line, one ``{"whisper_serve":
{...}}`` line, one ``{"train": {...}}`` line, one ``{"fleet": {...}}``
line, one ``{"lm_train": {...}}`` line, one ``{"sim": {...}}`` line, one
``{"rt": {...}}`` line, one ``{"launch": {...}}`` line, one
``{"kernels": [...]}`` line,
the script's seconds and, last, the device line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
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
# a bf16 output against its f32-computed plain version rounded to bf16:
# the two round f32 values that differ far less than an ulp, so they
# differ by at most one ulp of the element, and ulp(x) <= 2^-7 |x| in
# bf16. Where the outputs are small (non-causal attention over many keys
# averages v to ~0.04), BF16_TOL would pass a shift of several percent.
BF16_OUT_ULP = 2.0 ** -7

BATCH, PROMPT, STEPS = 4, 5120, 16
MAMBA_PROMPT = 8192                # 32 chunks of 256
MOE_PROMPT = 4096                  # B*S = 16384 > 4096: the MoE prefill
                                   # drops at capacity, decode is no_drop
WHISPER_BATCH, WHISPER_PROMPT = 16, 64   # 16 clips of 1500 frames; a
                                   # 64-token prompt + STEPS < 448 positions


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
        for fn, usage in _ptxas_usage(_build.build_log(name)):
            log(f"  {name}: {fn}: {usage}")
    return {"nvidia_smi": smi, "build_s": seconds}


def _ptxas_usage(text: str) -> list:
    """(kernel, 'N registers, smem, spills') for each entry function in an
    nvcc ``-Xptxas=-v`` log."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            rows.append((fn, line.split(":", 1)[1].strip() + "; " + spill))
            fn = None
    return rows


# --------------------------------------------------------------------------
# 2. kernels
# --------------------------------------------------------------------------

def _ptxas_entries(text: str) -> dict:
    """{mangled kernel: {registers, spill_bytes, static_smem}} from an nvcc
    ``-Xptxas=-v`` log."""
    import re
    usage, fn = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            usage[fn] = {"spill_bytes": int(re.search(
                r"(\d+) bytes spill stores", line).group(1))}
        elif fn and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            usage.setdefault(fn, {}).update(
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                static_smem=int(smem.group(1)) if smem else 0)
            fn = None
    return usage


def flash_bf16_build_check() -> list:
    """K1's bf16 kernels as ptxas built them (the ``-Xptxas=-v`` log of
    ``csrc/flash_attention.cu``): for each head dim, the kernel that runs
    there (warp-specialised from D = 64, one warpgroup below), with its
    registers a thread at launch (the warp-specialised consumers take 240,
    or 160 at D = 64, by ``setmaxnreg``), spill bytes and shared memory a
    block (static from the log plus the launcher's dynamic bytes). Fails
    if ptxas serialised any ``wgmma`` of a bf16 attention kernel or one of
    them spills."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    text = _build.build_log("flash_attention")
    if not text:
        raise AssertionError("no ptxas log for csrc/flash_attention.cu")
    serial = sorted({m.group(1) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized.*?'(\w+)'", text)})
    bad = [f for f in serial if "attn_ws_kernel" in f
           or "attn_bf16_kernel" in f]
    if bad:
        raise AssertionError(f"ptxas serialised wgmma in {bad}")
    usage = _ptxas_entries(text)
    rows = []
    for D in fk.HEAD_DIMS:
        name = ("attn_ws_kernel" if D >= 64 else "attn_bf16_kernel") \
            + f"ILi{D}E"
        found = [f for f in usage if name in f]
        if len(found) != 1:
            raise AssertionError(f"{name}: {len(found)} entries in the "
                                 "ptxas log")
        u = usage[found[0]]
        row = {"D": D, "kernel": name.split("ILi")[0],
               "registers": u["registers"], "spill_bytes": u["spill_bytes"],
               "smem_bytes": u["static_smem"] + fk.bf16_smem_bytes(D)}
        if row["spill_bytes"]:
            raise AssertionError(f"K1 bf16 at D = {D} spills: {row}")
        rows.append(row)
    log("flash_attention bf16 build: " + json.dumps(rows))
    return rows


def ssd_build_check() -> list:
    """K2's bf16 kernels as ptxas built them (the ``-Xptxas=-v`` log of
    ``csrc/ssd.cu``): for each (N, P) the chained kernel's registers a
    thread (at most 168 in a block of 288), spill bytes and shared memory
    a block (static from the log plus the launcher's dynamic bytes). Fails
    if ptxas serialised any ``wgmma`` of a chained kernel or one of them
    spills."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel as sk
    text = _build.build_log("ssd")
    if not text:
        raise AssertionError("no ptxas log for csrc/ssd.cu")
    serial = sorted({m.group(1) for m in re.finditer(
        r"wgmma\.mma_async instructions are serialized.*?'(\w+)'", text)})
    if serial:
        raise AssertionError(f"ptxas serialised wgmma in {serial}")
    usage = _ptxas_entries(text)
    rows = []
    for N in sk.STATE_DIMS:
        for P in sk.STATE_DIMS:
            name = f"ssd_chain_kernelILi{N}ELi{P}E"
            found = [f for f in usage if name in f]
            if len(found) != 1:
                raise AssertionError(f"{name}: {len(found)} entries in the "
                                     "ptxas log")
            u = usage[found[0]]
            rows.append({"N": N, "P": P, "registers": u["registers"],
                         "spill_bytes": u["spill_bytes"],
                         "smem_bytes": u["static_smem"]
                         + sk.bf16_smem_bytes(N, P)})
    log("ssd bf16 build: " + json.dumps(rows))
    spills = [r for r in rows if r["spill_bytes"]]
    if spills:
        raise AssertionError(f"K2 bf16 spills: {spills}")
    return rows


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
        for D in (16, 32, 64, 128, 192, 256):
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


# K1 at the MoE models' prefill shapes: (label, kv heads a row, R, D)
FLASH_MOE_SHAPES = [
    ("deepseek-v2-lite-16b MLA", 16, 1, 192),   # G = H = 16, qk 128 + 64
    ("phi3.5-moe / jamba GQA", 8, 4, 128),      # 32 heads over 8 kv heads
]


def _flash_row(gen, label: str, batch: int, G: int, R: int, Sq: int,
               Skv: int, D: int, causal: bool, reps: int) -> dict:
    """K1 in bf16 (no softcap, no window, scale 1 / sqrt(D)) on seeded
    q (batch*G*R, Sq, D), k = v (batch*G, Skv, D): its error against the
    plain version, within BF16_TOL and one ulp of the largest output
    (``BF16_OUT_ULP``), kernel, plain and library times over ``reps``
    launches and the bound. ``scaled_dot_product_attention`` computes
    exactly the same function here, so library_ms is a true yardstick;
    its error is kept too. The port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _flash_inputs(gen, batch * G, R, Sq, Skv, D, torch.bfloat16)
    kw = dict(causal=causal, window=0, softcap=0.0, q_offset=0, kv_repeat=R)
    got = flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = min(BF16_TOL, BF16_OUT_ULP * want.float().abs().max().item())
    if not err <= tol:
        raise AssertionError(f"flash_attention {label}: max abs err {err} "
                             f"> {tol}")
    q4 = q.view(batch, G * R, Sq, D)
    k4, v4 = k.view(batch, G, Skv, D), v.view(batch, G, Skv, D)
    lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q4, k4, v4, is_causal=causal, enable_gqa=R > 1)
    lib_err = (lib().reshape(q.shape).float() - want.float()
               ).abs().max().item()
    del want
    bound_ms, bound_by = _attention_bound_ms(
        batch * G * R, batch * G, Sq, Skv, D, torch.bfloat16, causal, 0)
    row = {"label": label, "shape": f"q ({batch * G * R},{Sq},{D}) "
           f"kv ({batch * G},{Skv},{D}) bf16 "
           + ("causal" if causal else "non-causal"),
           "max_abs_err": err, "tol": tol,
           "ms": time_ms(lambda: flash_attention_flat(q, k, v, **kw), reps),
           "plain_ms": time_ms(lambda: attention_ref(q, k, v, **kw), 2),
           "library_ms": time_ms(lib, reps), "library_max_abs_err": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, got
    torch.cuda.empty_cache()
    return row


def flash_moe_shapes() -> list:
    """K1 at the MoE models' prefill shapes (batch BATCH, MOE_PROMPT
    tokens, bf16, causal), ``_flash_row`` each."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, G, R, D in FLASH_MOE_SHAPES:
        rows.append(_flash_row(gen, label, BATCH, G, R, MOE_PROMPT,
                               MOE_PROMPT, D, True, 10))
        log("flash_attention moe shape: " + json.dumps(rows[-1]))
    return rows


# K1 at whisper-small's shapes (batch WHISPER_BATCH, 12 heads of 64):
# (label, query rows, key rows), non-causal
FLASH_WHISPER_SHAPES = [
    ("whisper-small encoder self-attention", 1500, 1500),
    ("whisper-small cross-attention, 64-token prompt", 64, 1500),
]


def _ragged_mask_probe(gen, BH: int, Sq: int, Skv: int, D: int) -> dict:
    """K1 in bf16, non-causal, on q ~ N(2, 1) and k ~ N(-2, 1): every
    real score is ~ -32, so a key past Skv in the last (ragged) key tile
    that is not masked (score 0 on zero-filled rows) would take nearly
    all the weight and move each output by its own size. Within
    BF16_TOL and one ulp of the largest output."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _flash_inputs(gen, BH, 1, Sq, Skv, D, torch.float32)
    q, k, v = (q + 2).bfloat16(), (k - 2).bfloat16(), v.bfloat16()
    kw = dict(causal=False, window=0, softcap=0.0, q_offset=0, kv_repeat=1)
    got = flash_attention_flat(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = min(BF16_TOL, BF16_OUT_ULP * want.float().abs().max().item())
    if not err <= tol:
        raise AssertionError(f"flash_attention ragged mask probe Sq={Sq} "
                             f"Skv={Skv}: max abs err {err} > {tol}")
    return {"mask_probe_err": err, "mask_probe_tol": tol}


def flash_whisper_shapes() -> list:
    """K1 at whisper-small's two prefill shapes, non-causal, D = 64,
    ``_flash_row`` each: the encoder's self-attention, q = k = v (16*12,
    1500, 64), ragged against the 64-row and 64-key tiles; and the
    decoder's cross-attention, q (16*12, 64, 64) over kv (16*12, 1500,
    64). Each row also holds ``_ragged_mask_probe`` at its Sq and Skv
    over one clip's 12 heads."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for label, Sq, Skv in FLASH_WHISPER_SHAPES:
        rows.append(_flash_row(gen, label, WHISPER_BATCH, 12, 1, Sq, Skv, 64,
                               False, 20))
        rows[-1].update(_ragged_mask_probe(gen, 12, Sq, Skv, 64))
        log("flash_attention whisper shape: " + json.dumps(rows[-1]))
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
    # ragged S: the chunk halves to 8; S < chunk (Q = 100); odd S (Q = 1);
    # S = 2 mod 4 (Q = 2)
    (2, 200, 32, 32, 64, "float32", False),
    (2, 100, 64, 128, 256, "bfloat16", False),
    (1, 129, 16, 16, 64, "float32", False),
    (2, 129, 64, 128, 256, "bfloat16", False),
    (2, 130, 64, 128, 256, "bfloat16", False),
    # exp(cum_i - cum_j) overflows above the diagonal: no NaN may leak
    (2, 256, 64, 128, 256, "float32", True),
    (2, 256, 64, 128, 256, "bfloat16", True),
    # jamba's N = 16 at its P = 64: chunk 256 in bf16, chunks of 64 in f32
    (2, 512, 64, 16, 256, "bfloat16", False),
    (2, 512, 64, 16, 64, "float32", False),
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


def _ssd_bound_ms(B_, S, H, G, P, N, Q, dtype):
    """Each input read once (B and C once per group), each output written
    once; the operations the chunked form needs: per (batch, group, chunk)
    C B^T over the Q(Q+1)/2 visible (i, j) pairs, per (batch, head, chunk)
    M x over those pairs and C h and the state update over Q*N*P each."""
    import torch
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    size = 2 if name == "bfloat16" else 4
    nbytes = size * (2 * B_ * S * H * P + 2 * B_ * S * G * N) \
        + 4 * (B_ * S * H + H + B_ * H * N * P)
    pairs = Q * (Q + 1) // 2
    nc = S // Q
    flops = B_ * G * nc * 2 * pairs * N \
        + B_ * H * nc * (2 * pairs * P + 4 * Q * N * P)
    t_ops = flops / PEAK_FLOPS[name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            {"bytes": nbytes, "flops": flops, "bytes_ms": 1e3 * t_bytes,
             "operations_ms": 1e3 * t_ops})


def _ssd_model_inputs(gen, B_, S, H, G, P, N, bc_scale=None):
    """x, B and C as mamba2's block hands them to the kernel: strided views
    of one packed bf16 projection (B, S, H*P + 2*G*N), B and C once per
    group; dt (B, S, H) and A (H,) in f32. Scaled as ``_ssd_inputs``
    unless ``bc_scale`` names B's and C's scale."""
    import torch
    import torch.nn.functional as F
    packed = torch.randn((B_, S, H * P + 2 * G * N), device="cuda",
                         generator=gen)
    packed[..., H * P:] *= (0.5 * min(1.0, 32 / N) if bc_scale is None
                            else bc_scale)
    packed = packed.to(torch.bfloat16)
    x = packed[..., :H * P].reshape(B_, S, H, P)
    Bm = packed[..., H * P:H * P + G * N].reshape(B_, S, G, N)
    Cm = packed[..., H * P + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(torch.randn((B_, S, H), device="cuda", generator=gen)
                    - 1.0)
    A = -torch.exp(torch.randn((H,), device="cuda", generator=gen) * 0.3)
    return x, dt, A, Bm, Cm


def ssd_shapes() -> dict:
    """K2 at the shape mamba2-2.7b's prefill gives it ("model": model
    layout, B = 4, H = 80, one group of B and C, through ``ops.ssd``) and
    at the flat per-head slice shape ("flat": x (320, 8192, 64), B and C
    per head, through ``ssd_flat``): error against the plain version,
    kernel and plain times and the bound of each. No single PyTorch call
    computes the SSD scan, so there is no library time."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.kernel import chunk_len, ssd_flat
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_grouped_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    B_, H, S, P, N, chunk = BATCH, 80, MAMBA_PROMPT, 64, 128, 256
    Q = chunk_len(S, chunk)
    cases = {
        "model": (lambda: _ssd_model_inputs(gen, B_, S, H, 1, P, N),
                  lambda a: ssd_ops.ssd(*a, chunk=chunk),
                  lambda a: ssd_grouped_ref(*a, chunk=Q), (B_, H, 1),
                  f"x ({B_},{S},{H},{P}) strided, B, C ({B_},{S},1,{N}) "
                  f"per group"),
        "flat": (lambda: _ssd_inputs(gen, B_ * H, S, P, N, torch.bfloat16),
                 lambda a: ssd_flat(*a, chunk=chunk),
                 lambda a: ssd_chunked_ref(*a, chunk=Q), (1, B_ * H, B_ * H),
                 f"x ({B_ * H},{S},{P}) B, C ({B_ * H},{S},{N}) per head")}
    rows = {}
    for label, (make, kernel, plain, (b, h, g), shape) in cases.items():
        args = make()
        got = kernel(args)
        torch.cuda.synchronize()
        err = _ssd_err(got, plain(args))
        if not err < SSD_BF16_TOL:
            raise AssertionError(f"ssd {label} shape: max abs err {err}")
        # the chain's result does not depend on which block ran what
        again = [kernel(args) for _ in range(2)]
        if not all(torch.equal(a[0], got[0]) and torch.equal(a[1], got[1])
                   for a in again):
            raise AssertionError(f"ssd {label} shape: three calls differ")
        del again
        bound_ms, bound_by, terms = _ssd_bound_ms(b, S, h, g, P, N, Q,
                                                  torch.bfloat16)
        rows[label] = {
            "shape": f"{shape}, bf16, chunk {Q}", "max_abs_err": err,
            "bit_equal_3_calls": True,
            "ms": time_ms(lambda: kernel(args), 10),
            "plain_ms": time_ms(lambda: plain(args), 2),
            "bound_ms": bound_ms, "bound_by": bound_by, **terms,
            # the call's CUDA kernels (the chained pass and the flag
            # reset in bf16), one profiled call
            "kernels_ms": device_profile(lambda: kernel(args))["top"]}
        log(f"ssd {label} shape: " + json.dumps(rows[label]))
        del args, got
        torch.cuda.empty_cache()
    return rows


def ssd_jamba_shape() -> dict:
    """K2 at the shape jamba's prefill gives it (its Mamba layers: B =
    BATCH, MOE_PROMPT tokens, 128 heads of P = 64, one group of B and C
    with N = 16, chunk 256, bf16, strided views of one packed projection,
    through ``ops.ssd``): error against the plain version, kernel and plain
    times and the byte bound. No PyTorch call computes the SSD scan.

    SSD_BF16_TOL is under one bf16 ulp only while |y| < 8. With
    ``_ssd_inputs``' scale of B and C (0.5 at N = 16) the largest |y| of
    this many outputs passes 8, where one ulp is 0.0625 and two roundings
    of nearly equal f32 values differ by it; B and C are scaled by 0.125
    here (the mamba2 rows' scale), and the plain version's largest |y| is
    checked below 8."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.kernel import chunk_len
    from repro_torch.kernels.ssd.ref import ssd_grouped_ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    B_, S, H, P, N, chunk = BATCH, MOE_PROMPT, 128, 64, 16, 256
    Q = chunk_len(S, chunk)
    args = _ssd_model_inputs(gen, B_, S, H, 1, P, N, bc_scale=0.125)
    got = ssd_ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = ssd_grouped_ref(*args, chunk=Q)
    err, y_max = _ssd_err(got, want), want[0].float().abs().max().item()
    del want
    if not y_max < 8:
        raise AssertionError(f"ssd jamba shape: plain max |y| {y_max} >= 8, "
                             f"past the bf16 limit's range")
    if not err < SSD_BF16_TOL:
        raise AssertionError(f"ssd jamba shape: max abs err {err}")
    bound_ms, bound_by, terms = _ssd_bound_ms(B_, S, H, 1, P, N, Q,
                                              torch.bfloat16)
    row = {"shape": f"x ({B_},{S},{H},{P}) strided, B, C ({B_},{S},1,{N}) "
                    f"per group, bf16, chunk {Q}",
           "max_abs_err": err, "max_abs_y": y_max,
           "ms": time_ms(lambda: ssd_ops.ssd(*args, chunk=chunk), 10),
           "plain_ms": time_ms(lambda: ssd_grouped_ref(*args, chunk=Q), 2),
           "bound_ms": bound_ms, "bound_by": bound_by, **terms}
    log("ssd jamba shape: " + json.dumps(row))
    del args, got
    torch.cuda.empty_cache()
    return row


def ssd_short_chunks() -> list:
    """K2 at mamba2-2.7b's model-path width (B = 4, H = 80, one group)
    with prompts whose chunk rule gives Q = 1 (8191 tokens) and Q = 2
    (8190): the peak memory of a call beyond its inputs (y, hT and the
    chain's scratch: two state slots and a flag a head), its time, and its
    error against the sequential scan."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    B_, H, P, N = BATCH, 80, 64, 128
    rows = []
    for S in (MAMBA_PROMPT - 1, MAMBA_PROMPT - 2):
        x, dt, A, Bm, Cm = _ssd_model_inputs(gen, B_, S, H, 1, P, N)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, hT = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=256)
        torch.cuda.synchronize()
        extra_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        if not (torch.isfinite(y.float()).all() and torch.isfinite(hT).all()):
            raise AssertionError(f"ssd S={S}: non-finite output")

        def flat(t):
            return t.permute(0, 2, 1, 3).reshape(B_ * H, S, t.shape[-1])
        y_p, h_p = ssd_scan_ref(
            flat(x), dt.permute(0, 2, 1).reshape(B_ * H, S), A.repeat(B_),
            flat(Bm.expand(B_, S, H, N)), flat(Cm.expand(B_, S, H, N)))
        err = max((flat(y).float() - y_p.float()).abs().max().item(),
                  (hT.reshape(B_ * H, N, P) - h_p).abs().max().item())
        if not err < SSD_BF16_TOL:
            raise AssertionError(f"ssd S={S}: max abs err {err} vs scan")
        Q = sk.chunk_len(S, 256)
        row = {"S": S, "Q": Q, "max_abs_err_vs_scan": err,
               "scratch_mb": sk.scratch_bytes(B_ * H, P, N) / 2**20,
               "peak_extra_mb": extra_mb,
               "ms": time_ms(lambda: ssd_ops.ssd(x, dt, A, Bm, Cm,
                                                 chunk=256), 2)}
        log("ssd short chunks: " + json.dumps(row))
        rows.append(row)
        del x, dt, A, Bm, Cm, y, hT, y_p, h_p
        torch.cuda.empty_cache()
    return rows


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
    batch = _serve_batch(cfg, 2, 40)
    outs, logits = [], []
    for c in (cfg, plain_cfg):
        eng = ServeEngine(c, params, cap=48, device="cuda")
        logits.append(eng.prefill(batch)[0])
        outs.append(eng.generate(batch, steps=8))
    err = (logits[0] - logits[1]).abs().max().item()
    if not (err < 1e-4 and torch.equal(outs[0], outs[1])):
        raise AssertionError(f"reduced {label} f32: kernel vs plain logits "
                             f"err {err}, tokens equal "
                             f"{torch.equal(outs[0], outs[1])}")
    log(f"reduced {label} f32 on the card: kernel vs plain logits max abs "
        f"err {err:.3g}, 8 greedy tokens identical")


def _serve_batch(cfg, batch_size: int, prompt: int) -> dict:
    """Seeded prompt tokens on the card; for an enc-dec model also seeded
    random frame embeddings (batch_size, enc_seq, d_model) in the compute
    dtype (the audio frontend is a stub)."""
    import torch
    from repro_torch import streams
    gen = streams.sampler_generator(1, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_size, prompt), device="cuda",
                                     generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn(
            (batch_size, cfg.enc_seq, cfg.d_model), device="cuda",
            generator=gen).to(getattr(torch, cfg.dtype))
    return batch


_LAUNCHED = []


def _launch_counter():
    """The hand-written kernels' launches by name
    (``telemetry.LaunchCounter``), counted from the first call on for the
    rest of the process."""
    if not _LAUNCHED:
        from repro_torch import telemetry
        _LAUNCHED.append(telemetry.LaunchCounter())
        telemetry.observers.append(_LAUNCHED[0])
    return _LAUNCHED[0]


def _expected_launches(cfg) -> dict:
    """Each kernel's launches in one generate: K1 once per attention layer
    and K2 once per Mamba layer of the prefill; decode launches neither.
    An enc-dec model's prefill runs K1 once per encoder layer and twice
    per decoder layer (self- and cross-attention)."""
    if cfg.encdec:
        n_dec = cfg.n_layers - cfg.n_enc_layers
        return {"flash_attention": cfg.n_enc_layers + 2 * n_dec, "ssd": 0}
    mixers = [s.mixer for s in cfg.layer_specs()]
    return {"flash_attention": mixers.count("attn"),
            "ssd": mixers.count("mamba")}


def serve(cfg, plain_cfg, prompt: int, moe: bool = False,
          batch_size: int = BATCH) -> dict:
    """``cfg`` at full width through ``ServeEngine.generate``
    (``batch_size`` requests of ``prompt`` tokens, for an enc-dec model
    with seeded random frames, STEPS greedy steps), with every kernel's
    launch count set to 0 just before that run and read just after; each
    kernel must
    have been launched once per layer of its kind
    (``_expected_launches``). Then a prefill and decode breakdown, a
    profile of one call each (``moe``: one prefill, the card alone), and
    the prefill logits against the plain path ``plain_cfg``: all rows
    within LOGITS_TOL, or for a MoE model the routing-flip rule of
    ``moe_routing_check``."""
    import torch
    from repro_torch import streams
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine
    t0 = time.perf_counter()
    params = api.init(streams.model_generator(0, "cuda"), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    param_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"{cfg.name} init: {n_params / 1e9:.3f} B params ({param_gb:.2f} GB, "
        f"{cfg.n_layers} layers) in {time.perf_counter() - t0:.2f} s")
    cap = prompt + STEPS
    eng = ServeEngine(cfg, params, cap=cap, device="cuda")
    batch = _serve_batch(cfg, batch_size, prompt)
    eng.generate(batch, steps=2)                      # warm-up
    torch.cuda.synchronize()

    # the main path, with the kernels' counts read around it
    counter = _launch_counter()
    counter.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(batch, steps=STEPS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = dict(counter)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != _expected_launches(cfg):
        raise AssertionError(f"{cfg.name}: kernel launches {launches} in one "
                             f"generate; expected {_expected_launches(cfg)} "
                             f"(one per layer of its kind in the prefill)")
    if out.shape != (batch_size, STEPS) or out.dtype != torch.int32 or not (
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
    if moe:
        profiles = {"prefill": device_profile(lambda: eng.prefill(batch),
                                              host_ops=False)}
    else:
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
    result = {
        "model": cfg.name, "n_layers": cfg.n_layers,
        "param_dtype": cfg.param_dtype, "params_b": n_params / 1e9,
        "params_gb": param_gb, "batch": batch_size, "prompt": prompt,
        "steps": STEPS, "cap": cap, "launches_per_generate": launches,
        "generate_s": generate_s,
        "tokens_per_s": batch_size * STEPS / generate_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "plain_prefill_ms": plain_prefill_ms,
        "logits_max_abs_err_vs_plain": err, "peak_memory_gb": peak_gb,
        "device_busy_share": {k: v["busy_share"]
                              for k, v in profiles.items()},
        "prefill_top_kernels_ms": profiles["prefill"]["top"],
        "first_row": out[0].tolist()}
    if moe:
        result["routing"] = moe_routing_check(eng, plain, batch, logits)
    elif not err <= LOGITS_TOL:
        raise AssertionError(f"{cfg.name} prefill logits: kernel vs plain "
                             f"path max abs err {err} > {LOGITS_TOL}")
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
    return serve(cfg, cfg.replace(attn_impl="naive"), PROMPT)


def mamba_serve_phase() -> dict:
    from repro_torch.configs import registry
    small = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype="float32", ssd_impl="pallas")
    small_path_check(small, small.replace(ssd_impl="scan"), "mamba2")
    cfg = registry.get("mamba2-2.7b").replace(ssd_impl="pallas")
    return serve(cfg, cfg.replace(ssd_impl="chunked"), MAMBA_PROMPT)


# --------------------------------------------------------------------------
# 5. moe_serve: deepseek-v2-lite, phi3.5-moe and jamba through K1 and K2
# --------------------------------------------------------------------------

# full width, bf16 params; the depth cut to what one 80 GB card holds
# beside the plain path's transients
MOE_MODELS = {
    "deepseek-v2-lite-16b": {},                 # full depth, 27 layers
    "phi3.5-moe-42b-a6.6b": {"n_layers": 8},    # 8 of 32 layers
    "jamba-v0.1-52b": {"n_layers": 8},          # 1 of 4 periods: every
                                                # layer kind
}


@contextlib.contextmanager
def _moe_routes(record: list, replay=None):
    """``models.common.moe_route`` wrapped for the calls inside: each MoE
    layer's top-k expert indices (the router's order) are appended to
    ``record``. With ``replay``, each layer takes the next of those
    indices instead of its own top-k, and its gates are its own
    probabilities there, renormalised."""
    import torch
    from repro_torch.models import common as cm
    orig = cm.moe_route
    given = iter(replay) if replay is not None else None

    def route(p, x, k):
        probs, w, idx = orig(p, x, k)
        if given is not None:
            idx = next(given)
            w = torch.gather(probs, -1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        record.append(idx)
        return probs, w, idx

    cm.moe_route = route
    try:
        yield
    finally:
        cm.moe_route = orig


@contextlib.contextmanager
def _first_flash_inputs(store: dict):
    """The first K1 call's flat q, k, v and options inside, copied into
    ``store``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    orig = fa_ops.flash_attention_flat

    def capture(q, k, v, **kw):
        if not store:
            store.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return orig(q, k, v, **kw)

    fa_ops.flash_attention_flat = capture
    try:
        yield
    finally:
        fa_ops.flash_attention_flat = orig


def moe_routing_check(eng, plain, batch, logits) -> dict:
    """The bf16 prefill logits of a MoE model, kernel path (``eng``, whose
    prefill gave ``logits``) against the plain path (``plain``). A bf16
    difference in an attention output can flip a near-tie in a router's
    top-k; that token then takes other experts and its logits move by
    O(1): another route, not a kernel error. The rule, none of it caught:

    1. K1 at the model's own q, k, v (the first attention layer of this
       prefill) against the plain attention, within BF16_TOL;
    2. per MoE layer, the tokens whose expert set differs between the two
       paths, counted and printed;
    3. the rows (requests) with no such token in any layer: last-position
       logits within LOGITS_TOL;
    4. the plain path replaying the kernel path's routes: every row within
       LOGITS_TOL."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S = batch["tokens"].shape
    kernel_routes, plain_routes, replayed, first = [], [], [], {}
    with _moe_routes(kernel_routes), _first_flash_inputs(first):
        logits_k, cache = eng.prefill(batch)
    del cache
    with _moe_routes(plain_routes):
        logits_p, cache = plain.prefill(batch)
    del cache
    with _moe_routes(replayed, replay=kernel_routes):
        logits_r, cache = plain.prefill(batch)
    del cache
    if not torch.equal(logits_k, logits):
        raise AssertionError("the kernel path's prefill is not repeatable")

    flips, last = [], torch.zeros(B, dtype=torch.bool, device="cuda")
    rows = torch.zeros(B, dtype=torch.bool, device="cuda")
    for a, b in zip(kernel_routes, plain_routes):
        diff = (a.reshape(B, S, -1).sort(-1).values
                != b.reshape(B, S, -1).sort(-1).values).any(-1)
        flips.append(int(diff.sum()))
        rows |= diff.any(-1)
        last |= diff[:, -1]
    err_rows = (logits_k - logits_p).abs().amax(-1)
    clean = ~rows
    err_clean = (float(err_rows[clean].max()) if bool(clean.any())
                 else None)
    err_replay = (logits_k - logits_r).abs().max().item()

    q, k, v, kw = first["q"], first["k"], first["v"], first["kw"]
    got = flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    err_k1 = (got.float() - attention_ref(q, k, v, **kw).float()
              ).abs().max().item()
    out = {"moe_layers": len(flips), "tokens": B * S,
           "flipped_tokens_per_layer": flips,
           "flipped_tokens": sum(flips),
           "rows_with_a_flipped_token": int(rows.sum()),
           "rows_whose_last_token_flipped": int(last.sum()),
           "logits_max_abs_err_rows_without_flip": err_clean,
           "logits_max_abs_err_per_row": err_rows.tolist(),
           "logits_max_abs_err_replayed_routes": err_replay,
           "k1_first_layer": {
               "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} "
                        f"{str(q.dtype).split('.')[1]}",
               "max_abs_err": err_k1}}
    log("routing: " + json.dumps(out))
    if not err_k1 < BF16_TOL:
        raise AssertionError(f"K1 at the model's first-layer q/k/v: max abs "
                             f"err {err_k1} >= {BF16_TOL}")
    if err_clean is not None and not err_clean <= LOGITS_TOL:
        raise AssertionError(f"prefill logits of the rows without a routing "
                             f"flip: max abs err {err_clean} > {LOGITS_TOL}")
    if not err_replay <= LOGITS_TOL:
        raise AssertionError(f"prefill logits, plain path on the kernel "
                             f"path's routes: max abs err {err_replay} > "
                             f"{LOGITS_TOL}")
    return out


def _moe_small(arch: str):
    """The reduced config in f32 on the kernel paths; deepseek's MLA keeps
    its real head dims (128 + 64), so its small check runs K1 at D = 192
    (``reduce_for_smoke``'s 16 + 8 is no kernel head dim)."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.reduce_for_smoke(registry.get(arch))
    if cfg.mla is not None:
        cfg = cfg.replace(mla=dataclasses.replace(
            cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg.replace(dtype="float32", attn_impl="pallas",
                       ssd_impl="pallas")


def moe_serve_phase() -> dict:
    """Each of MOE_MODELS: the reduced f32 check (tokens equal to the
    naive/scan path's), then ``serve`` at full width with bf16 params,
    batch BATCH, a MOE_PROMPT-token prompt and STEPS greedy steps, each
    model's params freed before the next."""
    from repro_torch.configs import registry
    out = {}
    for arch, cut in MOE_MODELS.items():
        t0 = time.perf_counter()
        small = _moe_small(arch)
        small_path_check(small, small.replace(attn_impl="naive",
                                              ssd_impl="scan"), arch)
        full = registry.get(arch)
        cfg = full.replace(param_dtype="bfloat16", attn_impl="pallas",
                           ssd_impl="pallas", **cut)
        out[arch] = serve(cfg, cfg.replace(attn_impl="naive",
                                           ssd_impl="chunked"),
                          MOE_PROMPT, moe=True)
        out[arch]["full_n_layers"] = full.n_layers
        out[arch]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# 6. whisper_serve: whisper-small through K1 at head dim 64
# --------------------------------------------------------------------------

def whisper_serve_phase() -> dict:
    """A reduced whisper in f32 at head dim 64 and 100 frames (ragged
    against K1's tiles) whose tokens must match the naive path's, then
    whisper-small at full width and depth (12 + 12 layers, d = 768, f32
    params, bf16 compute) through ``serve``: WHISPER_BATCH clips of 1500
    seeded random frame embeddings, a WHISPER_PROMPT-token prompt and
    STEPS greedy steps; K1 launched 12 + 2 * 12 = 36 times a generate,
    the prefill logits within LOGITS_TOL of the chunked path's."""
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    small = registry.reduce_for_smoke(registry.get("whisper-small")).replace(
        dtype="float32", attn_impl="pallas", head_dim=64, enc_seq=100)
    small_path_check(small, small.replace(attn_impl="naive"), "whisper")
    cfg = registry.get("whisper-small").replace(attn_impl="pallas")
    out = serve(cfg, cfg.replace(attn_impl="chunked"), WHISPER_PROMPT,
                batch_size=WHISPER_BATCH)
    out["enc_seq"] = cfg.enc_seq
    out["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# 7. train: the paper's LeNet with CPSL (Alg. 1) through CPSLTrainer
# --------------------------------------------------------------------------

TRAIN_ROUNDS = 8
# fused vs looped round on the card, per leaf, x max(1, max|leaf|): the
# same kernels on the same data with cuDNN's deterministic algorithms
FUSED_LOOPED_TOL = 1e-6
# one paper-config round, card vs CPU, per leaf, x max(1, max|leaf|), and
# the round's loss: tests/test_torch_cpsl.py's ATOL_PAPER (sums in another
# order move activations across ReLU zeros and max-pool ties)
CARD_CPU_TOL, CARD_CPU_LOSS_RTOL = 1e-3, 1e-4


def _max_leaf_err(a, b) -> float:
    from repro_torch import tree
    return max(float((x.double().cpu() - y.double().cpu()).abs().max())
               / max(1.0, float(x.double().abs().max()))
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _train_data():
    """Synthetic non-IID MNIST (the container has no MNIST): 8000 train
    and 1500 test images; 30 devices x 180 samples of 3 classes."""
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
    xtr, ytr, xte, yte = synthetic_mnist(8000, 1500, seed=0)
    idx = non_iid_split(ytr, n_devices=30, samples_per_device=180)
    return xtr, ytr, xte, yte, idx


def train_phase() -> dict:
    """The quickstart's first half at the paper's configuration: synthetic
    non-IID MNIST (8000 train, 1500 test; 30 devices x 180 samples of 3
    classes), SAA cut selection (Alg. 2), then ``CPSLTrainer`` for 8 rounds
    with Gibbs clustering (80 iterations) and M = 6 clusters of K = 5, B =
    16, L = 1 — looped, then fused, from one initial state. Checks, none
    caught: fused and looped agree per leaf (cuDNN deterministic); one
    round on the card agrees with the same round on the CPU; the fused
    round runs under ``set_sync_debug_mode("error")``; the loss after 8
    rounds is below the first round's."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import streams, tree
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.cpsl import CPSL, to_device
    from repro_torch.core.profile import lenet_profile
    from repro_torch.core.resource import saa_cut_selection
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import CPSLDataset, batch_seed
    from repro_torch.models import lenet
    from repro_torch.train.trainer import CPSLTrainer, TrainerCfg
    dev = torch.device("cuda")
    M, K, B, L = 6, 5, 16, 1

    xtr, ytr, xte, yte, idx = _train_data()
    ds = CPSLDataset(xtr, ytr, idx, batch=B)
    ncfg, prof = NetworkCfg(n_devices=M * K), lenet_profile()
    t0 = time.perf_counter()
    v, means = saa_cut_selection(prof, ncfg, B=B, L=L, n_clusters=M,
                                 cluster_size=K, n_samples=3, gibbs_iters=60)
    saa_s = time.perf_counter() - t0
    log(f"train: SAA cut v* = {v} ({lenet.LAYERS[v - 1]}) in {saa_s:.1f} s")
    xte_d, yte_d = torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev)

    def eval_fn(cp, state):
        params, _ = cp.export_params(state)
        return lenet.accuracy(params, xte_d, yte_d)

    def cpsl(fused):
        return CPSL(make_split_model("lenet", v), CPSLConfig(
            cut_layer=v, n_clusters=M, cluster_size=K, local_epochs=L,
            batch_per_device=B, fused_round=fused))

    state0 = cpsl(False).init_state(streams.model_generator(0, dev))
    counter = _launch_counter()       # this path runs no hand kernel
    counter.reset()
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.backends.cudnn.deterministic = True
    runs, out = {}, {"cut": v, "saa_s": saa_s, "saa_means_s": means.tolist(),
                     "rounds": TRAIN_ROUNDS, "config": {
                         "N": M * K, "M": M, "K": K, "B": B, "L": L,
                         "n_train": len(xtr), "n_test": len(xte),
                         "gibbs_iters": 80, "cudnn_deterministic": True}}
    for mode in ("looped", "fused"):
        trainer = CPSLTrainer(
            cpsl(mode == "fused"), ds, prof, ncfg, TrainerCfg(
                rounds=TRAIN_ROUNDS, ckpt_every=TRAIN_ROUNDS,
                ckpt_dir=str(ckpt_root / mode), resource_mgmt="gibbs",
                gibbs_iters=80), eval_fn=eval_fn, device=dev)
        torch.cuda.reset_peak_memory_stats()
        state = trainer.run(state=tree.map(torch.clone, state0), v=v)
        h = trainer.history
        wall = [1e3 * r["wall_s"] for r in h]
        train_ms = [1e3 * (r["wall_s"] - r["plan_s"]) for r in h]
        out[mode] = {
            "wall_ms": wall, "plan_ms": [1e3 * r["plan_s"] for r in h],
            "train_ms": train_ms,
            "ms_per_step": [t / (M * L) for t in train_ms],
            "loss": [r["loss"] for r in h], "acc": [r["eval"] for r in h],
            "sim_latency_s": [r["sim_latency_s"] for r in h],
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        if not h[-1]["loss"] < h[0]["loss"]:
            raise AssertionError(f"{mode}: loss after {TRAIN_ROUNDS} rounds "
                                 f"{h[-1]['loss']} is not below the first "
                                 f"round's {h[0]['loss']}")
        runs[mode] = (trainer, state)
        log(f"train {mode}: " + json.dumps(out[mode]))
    out["hand_kernel_launches"] = dict(counter)
    err = _max_leaf_err(runs["looped"][1], runs["fused"][1])
    out["fused_vs_looped_max_rel_err"] = err
    if not err <= FUSED_LOOPED_TOL:
        raise AssertionError(f"fused vs looped states: {err} > "
                             f"{FUSED_LOOPED_TOL}")

    # one round on the card against the same round on the CPU
    looped, fused = runs["looped"][0], runs["fused"][0]
    clusters, _, _ = looped._plan_round(v, 0)
    sizes = np.stack([ds.data_sizes(c) for c in clusters])

    def batch_fn(device):
        return lambda m, l: {k: to_device(a, device) for k, a in
                             ds.cluster_batch(clusters[m], seed=batch_seed(
                                 0, 0, m, l)).items()}

    s_card, m_card = looped.cpsl.run_round(
        tree.map(torch.clone, state0), batch_fn(dev), data_sizes=sizes)
    s_cpu, m_cpu = looped.cpsl.run_round(
        tree.map(lambda t: t.cpu(), state0), batch_fn("cpu"),
        data_sizes=sizes)
    err = _max_leaf_err(s_cpu, s_card)
    out["card_vs_cpu"] = {"max_rel_err": err, "loss_card": m_card["loss"],
                          "loss_cpu": m_cpu["loss"]}
    if not err <= CARD_CPU_TOL or not abs(
            m_card["loss"] - m_cpu["loss"]) <= CARD_CPU_LOSS_RTOL * abs(
            m_cpu["loss"]):
        raise AssertionError("card vs CPU round: " + json.dumps(
            out["card_vs_cpu"]))

    # the fused round with no host sync, then one profiled round each way
    dsd = fused._ds_dev
    table = to_device(dsd.round_index_table(clusters, 0, 0, L), dev)
    weights = to_device(dsd.cluster_weights(clusters), dev, torch.float32)
    state = tree.map(torch.clone, state0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, mt = fused.cpsl.run_round_fused(state, dsd.data, table,
                                               weights)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["fused_round_host_syncs"] = 0
    if not bool(torch.isfinite(mt["loss"])):
        raise AssertionError("non-finite fused-round loss")
    out["profile"] = {
        "fused_round": device_profile(lambda: fused.cpsl.run_round_fused(
            tree.map(torch.clone, state0), dsd.data, table, weights)),
        "looped_round": device_profile(lambda: looped.cpsl.run_round(
            tree.map(torch.clone, state0), batch_fn(dev),
            data_sizes=sizes))}
    out["device_busy_share"] = {k: p["busy_share"]
                                for k, p in out["profile"].items()}
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# 8. fleet: FleetRunner over CPSL.run_fleet, and the batched planner
# --------------------------------------------------------------------------

# The grids (FleetConfig fields). QUICKSTART_FLEET is examples/quickstart.py's
# fleet, README_FLEET README.md's "Experiment fleets" grid (fig. 6's N_m of
# benchmarks/fig6_cluster_size.py, three seeds), LR_FLEET the lr x seed
# grid of benchmarks/bench_fleet.py at cluster size 5.
QUICKSTART_FLEET = dict(rounds=8, seeds=(0, 1), cluster_sizes=(5, 10),
                        n_devices=30, eval_every=4)
README_FLEET = dict(rounds=20, seeds=(0, 1, 2), cluster_sizes=(3, 5, 10),
                    n_devices=30, eval_every=5)
LR_FLEET = dict(rounds=8, seeds=(0, 1), cluster_sizes=(5,),
                lr_scales=(0.5, 1.0, 1.5, 2.0), n_devices=30, eval_every=4)
GIBBS_MC_ROUNDS, GIBBS_MC_CHAINS = 3, 4
# a replica against its solo run after the first cluster of round 1, per
# leaf x max(1, max|leaf|): tests/test_torch_cpsl.py's ATOL_PAPER, and
# the first cluster's loss. Later the two part: the batched kernels sum in
# another order, and once an activation sits within those bits of a ReLU
# zero or a max-pool tie this training amplifies the gap ~14x a step
# (1.4e-5 -> 2.7e-3 over one round of one replica of the README grid on
# the CPU, the others at 1e-8; tests/test_torch_fleet.py). So the script
# checks the first cluster and the integer leaves of the whole curve, and
# prints the float gap after one round and after the curve.
FLEET_FIRST_CLUSTER_TOL, FLEET_LOSS_RTOL = 1e-3, 1e-4


def _fleet_ccfg(cut):
    """The README's fleet lowering (im2col convolutions; the scan fields
    are the reference's and change nothing in the port)."""
    from repro_torch.configs.base import CPSLConfig
    return CPSLConfig(cut_layer=cut, conv_impl="im2col", scan_rounds=True,
                      fused_round_unroll=1)


def _bit_equal(a, b) -> bool:
    """Equal bit for bit, NaN slots included."""
    import torch
    if a.dtype.is_floating_point:
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
    return torch.equal(a, b)


def _replica_gap(solo, states, e):
    """(max float error of replica e against its solo state, per leaf x
    max(1, max|leaf|); integer leaves equal). Padded client rows of the
    fleet's dev stacks are cut to the solo's."""
    from repro_torch import tree
    err, ints = 0.0, True
    for a, b in zip(tree.leaves(solo), tree.leaves(states)):
        b = b[e][:a.shape[0]] if a.dim() else b[e]
        if a.dtype.is_floating_point:
            err = max(err, float((a.double() - b.double()).abs().max())
                      / max(1.0, float(a.double().abs().max())))
        else:
            ints = ints and bool((a == b).all())
    return err, ints


def _ids(clusters) -> list:
    return [[int(d) for d in c] for c in clusters]


def _solo_runs(fr, rounds, clusters=None, with_eval=True):
    """Each replica of FleetRunner ``fr`` as a solo ``run_training_fused``
    curve at its own unpadded layout (its seed's init, its lr scale) over
    the first ``rounds`` rounds (and ``clusters`` clusters of each), timed
    one by one on the card. Returns [(state, metrics, wall_ms)]."""
    import dataclasses
    import torch
    from repro_torch import streams
    from repro_torch.core.cpsl import CPSL
    out = []
    for e, sp in enumerate(fr.specs):
        Me, Ke = sp["n_clusters"], sp["cluster_size"]
        if clusters is not None:
            Me = min(Me, clusters)
        cp = CPSL(fr.cpsl.split, dataclasses.replace(
            fr.ccfg, n_clusters=Me, cluster_size=Ke))
        lr = None if fr.lr_scale is None else float(fr.lr_scale[e])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cp.init_state(streams.model_generator(sp["seed"], fr.device))
        state, m = cp.run_training_fused(
            state, fr.dsd.data, fr.plan.idx[e, :rounds, :Me, :, :Ke],
            fr.plan.weights[e, :Me, :Ke], lr_scale=lr,
            eval_data=fr.dsd.eval_data if with_eval else None,
            eval_every=fr.fcfg.eval_every if with_eval else 0)
        torch.cuda.synchronize()
        out.append((state, m, 1e3 * (time.perf_counter() - t0)))
    return out


def _fleet_call(fr, states, tb, rounds, clusters=None, idx=None,
                with_eval=True):
    """``CPSL.run_fleet`` over the first ``rounds`` rounds (and
    ``clusters`` cluster slots of each) of the runner's uploaded tables
    ``tb``; ``idx`` replaces its index table."""
    idx = tb["idx"] if idx is None else idx
    c = slice(None, clusters)

    def cut(t, axis):
        return None if t is None else t[(slice(None),) * axis + (c,)]

    return fr.cpsl.run_fleet(
        states, fr.dsd.data, idx[:, :rounds, c], cut(tb["weights"], 1),
        lr_scale=tb["lr_scale"],
        eval_data=fr.dsd.eval_data if with_eval else None,
        eval_every=fr.fcfg.eval_every if with_eval else 0,
        cluster_mask=cut(tb["cluster_mask"], 1),
        client_mask=cut(tb["client_mask"], 1),
        keep=None if tb["keep"] is None else tb["keep"][:, :rounds, c])


def _solo_gaps(fr, tb, rounds, clusters=None, label="", tol=None) -> list:
    """Per replica, the float gap to its solo run after the first
    ``rounds`` rounds (``clusters`` clusters each); integer leaves must be
    equal, and with ``tol`` the gap must be within it and the losses
    within FLEET_LOSS_RTOL."""
    states = fr.cpsl.init_fleet_state(fr.plan.seeds, fr.device)
    states, mf = _fleet_call(fr, states, tb, rounds, clusters,
                             with_eval=False)
    gaps = []
    for e, (solo, ms, _) in enumerate(_solo_runs(fr, rounds, clusters,
                                                 with_eval=False)):
        err, ints = _replica_gap(solo, states, e)
        lf, ls = float(mf["loss"][e, -1]), float(ms["loss"][-1])
        gaps.append(err)
        if not ints or (tol is not None and not (
                err <= tol and abs(lf - ls) <= FLEET_LOSS_RTOL * abs(ls))):
            raise AssertionError(
                f"{label}: replica {e} after {rounds} round(s), "
                f"{clusters or 'all'} cluster(s): max rel err {err} (limit "
                f"{tol}), integers equal {ints}, loss {lf} vs solo {ls}")
    return gaps


def fleet_phase(train: dict, smi: str) -> dict:
    """The quickstart's fleet half on the train phase's data and SAA cut.
    Checks, none caught: every loss of a real slot finite (lr scales up to
    1.0); each README-grid replica against its solo run (the first
    cluster: floats within FLEET_FIRST_CLUSTER_TOL; 20 rounds: integer
    leaves equal); a perturbed padded slot changes no output bit (cuDNN
    deterministic); the README grid's run_fleet call under
    ``set_sync_debug_mode("error")``; the lr-1.0 replicas of the lr grid
    against the solo runs at the base lr; the batched SAA's v* and means
    equal to the looped SAA's; gibbs-mc's chain 0 equal to the "gibbs"
    plan and its best-of-4 latency never above it; K1 and K2 launched 0
    times."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import streams, tree
    from repro_torch.configs.base import CPSLConfig, FleetConfig
    from repro_torch.core import resource as rs
    from repro_torch.core.channel import NetworkCfg, sample_network
    from repro_torch.core.cpsl import CPSL, to_device
    from repro_torch.core.profile import lenet_profile
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import CPSLDataset
    from repro_torch.sim.batched import (gibbs_clustering_multichain,
                                         saa_cut_selection_batched)
    from repro_torch.train.trainer import (CPSLTrainer, FleetRunner,
                                           TrainerCfg)
    dev = torch.device("cuda")
    xtr, ytr, xte, yte, idx = _train_data()
    v = train["cut"]
    prof, ncfg = lenet_profile(), NetworkCfg(n_devices=30)
    counter = _launch_counter()
    counter.reset()
    torch.backends.cudnn.deterministic = True
    out = {"card": smi, "cudnn_deterministic": True}

    def runner(grid, cut):
        return FleetRunner(xtr, ytr, FleetConfig(**grid), _fleet_ccfg(cut),
                           xte=xte, yte=yte, prof=prof, ncfg=ncfg,
                           device=dev)

    def real_losses_finite(res, max_lr=1.0):
        for rep in res["replicas"]:
            if rep["lr_scale"] <= max_lr and not np.isfinite(
                    rep["loss"]).all():
                raise AssertionError(f"non-finite loss in {rep}")

    def replicas(res):
        return [{k: rep[k] for k in ("seed", "cluster_size", "lr_scale")}
                | {"loss": rep["loss"][-1], "acc": rep["acc"][-1],
                   "sim_time_s": rep["sim_time_s"][-1]}
                for rep in res["replicas"]]

    # 1. the quickstart's fleet
    fr = runner(QUICKSTART_FLEET, v)
    res = fr.run()
    real_losses_finite(res)
    out["quickstart"] = {"grid": QUICKSTART_FLEET, "cut": v,
                         "padded_MK": [fr.ccfg.n_clusters,
                                       fr.ccfg.cluster_size],
                         "wall_ms": 1e3 * res["wall_s"],
                         "replicas": replicas(res)}
    log("fleet quickstart: " + json.dumps(out["quickstart"]))

    # 2. the README grid at full size
    fr = runner(README_FLEET, 3)
    R, L = fr.plan.idx.shape[1], fr.ccfg.local_epochs
    M_pad = fr.ccfg.n_clusters
    first = fr.run()
    real_losses_finite(first)
    tb = fr.upload()
    states0 = fr.cpsl.init_fleet_state(fr.plan.seeds, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_ref, m_ref = _fleet_call(fr, tree.map(torch.clone, states0), tb, R)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    poked = fr.plan.idx.copy()
    pad = ~np.broadcast_to(fr.plan.client_mask[:, None, :, None, :, None],
                           poked.shape)
    poked[pad] = (poked[pad] + 7) % len(xtr)
    s_poke, m_poke = _fleet_call(fr, tree.map(torch.clone, states0), tb, R,
                                 idx=to_device(poked, dev))
    same = (all(_bit_equal(a, b) for a, b in zip(tree.leaves(s_ref),
                                                  tree.leaves(s_poke)))
            and all(_bit_equal(m_ref[k], m_poke[k])
                    for k in ("losses", "loss"))
            and all(_bit_equal(m_ref["eval"][k], m_poke["eval"][k])
                    for k in ("acc", "loss")))
    if not same:
        raise AssertionError("README grid: perturbing padded slots changed "
                             "an output")
    torch.cuda.reset_peak_memory_stats()
    timed = fr.run()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    solos = _solo_runs(fr, R)
    gaps = []
    for e, (solo, ms, _) in enumerate(solos):
        err, ints = _replica_gap(solo, s_ref, e)
        if not ints:
            raise AssertionError(f"README grid: replica {e}'s integer "
                                 f"leaves differ from its solo run's")
        gaps.append(err)
    first_cluster = _solo_gaps(fr, tb, 1, 1, "README grid",
                               FLEET_FIRST_CLUSTER_TOL)
    one_round = _solo_gaps(fr, tb, 1, label="README grid")
    prof1 = device_profile(lambda: _fleet_call(
        fr, tree.map(torch.clone, states0), tb, 1, with_eval=False))
    steps = R * M_pad * L
    out["readme_grid"] = {
        "grid": README_FLEET, "cut": 3, "n_replicas": len(fr.specs),
        "padded_MK": [M_pad, fr.ccfg.cluster_size],
        "samples_per_step": len(fr.specs) * fr.ccfg.cluster_size
        * fr.ccfg.batch_per_device,
        "fleet_wall_ms_first": 1e3 * first["wall_s"],
        "fleet_wall_ms": 1e3 * timed["wall_s"],
        "ms_per_batched_step": 1e3 * timed["wall_s"] / steps,
        "batched_steps": steps,
        "solo_wall_ms": [w for _, _, w in solos],
        "solo_wall_ms_sum": sum(w for _, _, w in solos),
        "solo_steps": int(sum(int(s["step"]) for s, _, _ in solos)),
        "first_cluster_max_rel_err": first_cluster,
        "one_round_max_rel_err": one_round,
        "final_max_rel_err": gaps,
        "padded_perturbation_bit_identical": True,
        "run_fleet_host_syncs": 0,
        "device_busy_share_one_round": prof1["busy_share"],
        "profile_one_round": prof1, "peak_memory_mb": peak_mb,
        "replicas": replicas(timed)}
    log("fleet README grid: " + json.dumps(out["readme_grid"]))

    # 3. the lr x seed grid (homogeneous: no masks)
    fr = runner(LR_FLEET, 3)
    res = fr.run()
    real_losses_finite(res)
    tb = fr.upload()
    s_fleet, _ = _fleet_call(fr, fr.cpsl.init_fleet_state(fr.plan.seeds,
                                                          dev),
                             tb, fr.fcfg.rounds)
    base = [e for e, sp in enumerate(fr.specs) if sp["lr_scale"] == 1.0]
    baked = CPSL(fr.cpsl.split, fr.ccfg)
    for e in base:
        solo, _ = baked.run_training_fused(
            baked.init_state(streams.model_generator(fr.specs[e]["seed"],
                                                     dev)),
            fr.dsd.data, fr.plan.idx[e], fr.plan.weights[e])
        if not _replica_gap(solo, s_fleet, e)[1]:
            raise AssertionError(f"lr grid: replica {e}'s integer leaves "
                                 "differ from the baked-lr solo run's")
    lr_first = _solo_gaps(fr, tb, 1, 1, "lr grid", FLEET_FIRST_CLUSTER_TOL)
    out["lr_grid"] = {"grid": LR_FLEET, "cut": 3,
                      "wall_ms": 1e3 * res["wall_s"],
                      "ms_per_batched_step": 1e3 * res["wall_s"]
                      / (fr.fcfg.rounds * fr.ccfg.n_clusters),
                      "lr_1_replicas": base,
                      "first_cluster_max_rel_err": lr_first,
                      "replicas": replicas(res)}
    log("fleet lr grid: " + json.dumps(out["lr_grid"]))

    # 4. the batched planner
    t0 = time.perf_counter()
    vb, means_b = saa_cut_selection_batched(
        prof, ncfg, B=16, L=1, n_clusters=6, cluster_size=5, n_samples=3,
        gibbs_iters=60, chains=1)
    saa_b = time.perf_counter() - t0
    if vb != v or not np.array_equal(means_b, np.array(train["saa_means_s"])):
        raise AssertionError(f"batched SAA v*={vb} {means_b.tolist()} vs "
                             f"looped v*={v} {train['saa_means_s']}")
    ckpt = ROOT / "build" / "chip_smoke_ckpt" / "gibbs_mc"
    shutil.rmtree(ckpt, ignore_errors=True)
    ccfg = CPSLConfig(cut_layer=v, n_clusters=6, cluster_size=5,
                      local_epochs=1, batch_per_device=16, fused_round=True)
    trainer = CPSLTrainer(
        CPSL(make_split_model("lenet", v), ccfg),
        CPSLDataset(xtr, ytr, idx, batch=16), prof, ncfg,
        TrainerCfg(rounds=GIBBS_MC_ROUNDS, ckpt_every=GIBBS_MC_ROUNDS,
                   ckpt_dir=str(ckpt), resource_mgmt="gibbs-mc",
                   gibbs_iters=80, gibbs_chains=GIBBS_MC_CHAINS),
        device=dev)
    trainer.run(generator=streams.model_generator(0, dev), v=v)
    shutil.rmtree(ckpt, ignore_errors=True)
    rounds = []
    for rnd, h in enumerate(trainer.history):
        net = sample_network(ncfg, trainer.mu_f, trainer.mu_snr,
                             streams.trainer_round_rng(0, rnd))
        t0 = time.perf_counter()
        g = rs.gibbs_clustering(v, net, ncfg, prof, 16, 1, 6, 5, iters=80,
                                seed=rnd)
        gibbs_s = time.perf_counter() - t0
        full = gibbs_clustering_multichain(v, net, ncfg, prof, 16, 1, 6, 5,
                                           iters=80, seed=rnd,
                                           chains=GIBBS_MC_CHAINS, full=True)
        c0 = full.chain_results[0]
        if not (_ids(c0[0]) == _ids(g[0]) and c0[2] == g[2]
                and all(np.array_equal(a, b) for a, b in zip(c0[1], g[1]))):
            raise AssertionError(f"gibbs-mc round {rnd}: chain 0 is not the "
                                 "gibbs plan")
        if not (full.latency <= g[2] and h["sim_latency_s"] == full.latency):
            raise AssertionError(
                f"gibbs-mc round {rnd}: best-of-{GIBBS_MC_CHAINS} "
                f"{full.latency} vs gibbs {g[2]}, trainer "
                f"{h['sim_latency_s']}")
        rounds.append({"round": rnd, "plan_s": h["plan_s"],
                       "gibbs_plan_s": gibbs_s, "wall_s": h["wall_s"],
                       "latency_s": full.latency, "gibbs_latency_s": g[2],
                       "best_chain": full.best_chain, "loss": h["loss"]})
    out["planner"] = {"saa_looped_s": train["saa_s"], "saa_batched_s": saa_b,
                      "v_star": vb, "saa_means_equal": True,
                      "gibbs_mc": rounds}
    log("fleet planner: " + json.dumps(out["planner"]))
    out["hand_kernel_launches"] = dict(counter)
    if any(out["hand_kernel_launches"].values()):
        raise AssertionError("fleet phase launched a hand kernel: "
                             + json.dumps(out["hand_kernel_launches"]))
    torch.backends.cudnn.deterministic = False
    return out


# --------------------------------------------------------------------------
# 9. lm_train: split-LM CPSL training through K1 and K2
# --------------------------------------------------------------------------

# N = 4 devices in M = 2 clusters of K = 2, L = 1, 2 rounds (4 cluster
# steps); SGD at CPSLConfig's lrs (0.05 device, 0.25 server). Each model
# below: its kernel, the kernel path's and the plain path's cfg, the
# sequence, the sequences (clips) a device, and where given the cut (else
# SAA over cuts 1..6, or over the encoder's cuts, of the full
# architecture's profile with examples/cpsl_llm_training.py's network) and
# changes to the config. Against the registry's train_4k cell (global
# batch 256) a cluster step takes K * B sequences.
LM_M, LM_K, LM_B, LM_ROUNDS = 2, 2, 2, 2
LM_LOSS_CHUNK = 512       # the CE never holds (B*S, 256000) f32 logits
# deepseek-v2-lite-16b trains at full width with bf16 params, cut to 14 of
# 27 layers (the dense one and 13 MoE): SGD's functional update holds the
# old params, their gradients and the new params at once, ~3 x 16.8 GB,
# plus f32 transients of the largest stacked leaf (13 layers' experts,
# 2.4 B elements); the 27 layers would need ~134 GB.
DEEPSEEK_TRAIN_LAYERS = 14
LM_MODELS = {
    "gemma2-2b": dict(kernel="flash_attention", impl={"attn_impl": "pallas"},
                      plain={"attn_impl": "chunked"}, seq=PROMPT, batch=LM_B),
    "mamba2-2.7b": dict(kernel="ssd", impl={"ssd_impl": "pallas"},
                        plain={"ssd_impl": "chunked"}, seq=4096, batch=LM_B),
    # the cut inside the encoder; seq is the decoder's context (448
    # positions), the encoder reads 1500 frames a clip
    "whisper-small": dict(kernel="flash_attention",
                          impl={"attn_impl": "pallas"},
                          plain={"attn_impl": "chunked"}, seq=448, batch=4),
    # slice 5b: MLA through K1 at D = 192, MoE layers, bf16 params
    "deepseek-v2-lite-16b": dict(
        kernel="flash_attention", impl={"attn_impl": "pallas"},
        plain={"attn_impl": "chunked"}, seq=4096, batch=1, cut=1,
        cfg={"param_dtype": "bfloat16",
             "n_layers": DEEPSEEK_TRAIN_LAYERS}),
}
# kernel path vs plain path, per-leaf parameter gradients of one block at
# full width, err / max(1, max|g|): tests/test_kernels.py's tolerances
LM_GRAD_TOL = {("flash_attention", "float32"): 1e-4,
               ("ssd", "float32"): 5e-5,
               ("flash_attention", "bfloat16"): 3e-2,
               ("ssd", "bfloat16"): 5e-2}


def _lm_launches_per_step(cfg, kernel: str, v: int) -> int:
    """K1 (or K2) launches in one fused CPSL step with remat: every layer
    of the kernel's kind runs forward once and again in backward (the
    checkpoint's recompute; the Function's backward itself is plain
    torch), the device side once per client: 2 * (K*v + n_layers - v)
    when every layer is of that kind. An enc-dec split runs its encoder
    blocks without remat (the reference's plain scan) and its decoder's
    self- and cross-attention twice: K*v + (n_enc - v) + 4 * n_dec."""
    if cfg.encdec:
        if kernel != "flash_attention":
            return 0
        n_enc = cfg.n_enc_layers
        return LM_K * v + (n_enc - v) + 4 * (cfg.n_layers - n_enc)
    kind = "attn" if kernel == "flash_attention" else "mamba"
    specs = cfg.layer_specs()
    dev = sum(s.mixer == kind for s in specs[:v])
    srv = sum(s.mixer == kind for s in specs[v:])
    return 2 * (LM_K * dev + srv)


def _grad_blocks(cfg, seq: int, dtype: str) -> list:
    """(label, init(generator, cfg), apply(params, x, cfg, positions) -> y,
    x's shape) for one block of each kind of the model: whisper's encoder
    block (1500 frames) and decoder block (``seq`` tokens over a fixed
    random memory of 1500 frames: causal self-attention and non-causal
    cross-attention at Sq != Skv), else one block per layer spec."""
    import torch
    from repro_torch import streams
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as whp
    d = cfg.d_model
    if cfg.encdec:
        memory = torch.randn((1, cfg.enc_seq, d), device="cuda",
                             generator=streams.sampler_generator(5, "cuda")
                             ).to(getattr(torch, dtype))
        return [("encoder", whp._enc_block_init,
                 lambda p, x, c, pos: whp.enc_block_apply(p, x, c),
                 (1, cfg.enc_seq, d)),
                ("decoder", whp._dec_block_init,
                 lambda p, x, c, pos: whp.dec_block_apply(p, x, memory, c,
                                                          pos),
                 (1, seq, d))]
    return [(f"{s.mixer}_{s.ffn}_window{s.window}",
             lambda g, c, s=s: tfm.block_init(g, c, s),
             lambda p, x, c, pos, s=s: tfm.block_apply(p, x, c, s, pos)[0],
             (1, seq, d))
            for s in dict.fromkeys(cfg.layer_specs())]


def _lm_grad_check(cfg, kernel: str, impl: dict, plain: dict,
                   seq: int) -> dict:
    """One block of each kind of the model at full width, B = 1: per-leaf
    parameter gradients through the kernel path against the plain path,
    in float32 and in bfloat16 compute (f32 params), within LM_GRAD_TOL;
    the kernel must launch on the kernel path, no leaf's gradient may be
    all zero. A MoE block's plain path replays the kernel path's routes
    (``_moe_routes``), so a routing flip is not read as a gradient
    error."""
    import torch
    from repro_torch import streams, tree
    counter = _launch_counter()
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        for label, init, apply, shape in _grad_blocks(c, seq, dtype):
            params = init(streams.model_generator(3, "cuda"), c)
            gen = streams.sampler_generator(4, "cuda")
            x = torch.randn(shape, device="cuda",
                            generator=gen).to(getattr(torch, dtype))
            w = torch.randn(shape, device="cuda", generator=gen)
            pos = torch.arange(shape[1], device="cuda")
            grads, routes = [], []
            for kw in (impl, plain):
                p = tree.map(lambda t: t.detach().requires_grad_(), params)
                before = counter[kernel]
                with _moe_routes([] if kw is plain else routes,
                                 replay=routes if kw is plain else None):
                    y = apply(p, x, c.replace(**kw), pos)
                loss = (y.float() * w).sum() / shape[1]
                grads.append(torch.autograd.grad(loss, tree.leaves(p)))
                launched = counter[kernel] - before
                if (launched > 0) != (kw is impl):
                    raise AssertionError(f"{cfg.name} {label} {dtype}: "
                                         f"{kw} launched {kernel} "
                                         f"{launched} times")
            err = max(float((a - b).abs().max())
                      / max(1.0, float(b.abs().max()))
                      for a, b in zip(*grads))
            zero = [i for i, g in enumerate(grads[0])
                    if not bool(g.abs().max() > 0)]
            tol = LM_GRAD_TOL[kernel, dtype]
            if zero or not err <= tol:
                raise AssertionError(f"{cfg.name} {label} {dtype}: kernel "
                                     f"vs plain grads {err} (limit {tol}); "
                                     f"all-zero leaves {zero}")
            out[f"{label}_{dtype}"] = {"max_rel_err": err, "tol": tol,
                                       "moe_layers_replayed": len(routes)}
            del params, grads, x, w, routes
            torch.cuda.empty_cache()
    return out


def _lm_kernel_calls(cfg, kernel: str, v: int, seq: int,
                     batch: int) -> list:
    """The kernel's ``autograd.Function`` backwards in one CPSL step, by
    shape: (label, batch, Sq, Skv, causal, window, calls). Each layer of
    the kernel's kind runs one backward, the device side at B sequences
    once per client, the server side at K*B; an enc-dec model's encoder
    reads enc_seq frames (non-causal), its decoder runs causal
    self-attention over ``seq`` tokens and cross-attention from them over
    the frames."""
    Bs = LM_K * batch
    if cfg.encdec:
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers - cfg.n_enc_layers
        E = cfg.enc_seq
        return [("encoder, device", batch, E, E, False, 0, LM_K * v),
                ("encoder, server", Bs, E, E, False, 0, n_enc - v),
                ("decoder self", Bs, seq, seq, True, 0, n_dec),
                ("decoder cross", Bs, seq, E, False, 0, n_dec)]
    kind = "attn" if kernel == "flash_attention" else "mamba"
    calls = {}
    for i, s in enumerate(cfg.layer_specs()):
        if s.mixer == kind:
            where = ("device", batch, LM_K) if i < v else ("server", Bs, 1)
            key = (where[0], where[1], s.window if kind == "attn" else 0)
            calls[key] = calls.get(key, 0) + where[2]
    return [(f"{w}" + (f", window {win}" if win else ""), b, seq, seq,
             True, win, n) for (w, b, win), n in calls.items()]


def _lm_kernel_bwd(cfg, kernel: str, v: int, seq: int, batch: int) -> dict:
    """In bf16 at each shape of ``_lm_kernel_calls``: one kernel launch
    (the Function's forward) against the Function's backward (the plain
    recomputation and its gradient), CUDA events, and the backwards' sum
    over a step, each shape's time by its calls. An MLA model attends as
    H kv heads of one query head at D = dn + dr."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, device="cuda", generator=gen)
                ).to(dtype)

    shapes = []
    for label, Bs, Sq, Skv, causal, window, calls in _lm_kernel_calls(
            cfg, kernel, v, seq, batch):
        if kernel == "flash_attention":
            from repro_torch.kernels.flash_attention import ops
            if cfg.attn_kind == "mla":
                G, R = cfg.n_heads, 1
                hd = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            else:
                G, hd = cfg.n_kv_heads, cfg.resolved_head_dim
                R = cfg.n_heads // G
            ins = [rnd(Bs, Sq, G, R, hd), rnd(Bs, Skv, G, hd),
                   rnd(Bs, Skv, G, hd)]
            args = (causal, window, cfg.attn_softcap, 0)
            shape = (f"q ({Bs},{Sq},{G},{R},{hd}) kv ({Bs},{Skv},{G},{hd})"
                     f" bf16, {'causal' if causal else 'non-causal'}, "
                     f"window {window}")

            def fwd(ins=ins, args=args):
                return ops.flash_attention(*ins, *args)
        else:
            from repro_torch.kernels.ssd import ops
            from repro_torch.models.mamba2 import mamba_dims
            _, H, _ = mamba_dims(cfg)
            s = cfg.ssm
            ins = [rnd(Bs, seq, H, s.headdim),
                   rnd(Bs, seq, H, dtype=torch.float32, scale=0.1).abs(),
                   -torch.rand(H, device="cuda", generator=gen) - 0.5,
                   rnd(Bs, seq, s.ngroups, s.d_state, scale=0.3),
                   rnd(Bs, seq, s.ngroups, s.d_state, scale=0.3)]
            shape = f"x ({Bs},{seq},{H},{s.headdim}) bf16, B = C " \
                    f"({Bs},{seq},{s.ngroups},{s.d_state})"

            def fwd(ins=ins):
                return ops.ssd(*ins, chunk=s.chunk_size)[0]
        with torch.no_grad():
            fwd_ms = time_ms(fwd, 3)
        ins[:] = [t.requires_grad_() for t in ins]
        out = fwd()
        g = torch.randn_like(out)
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, ins, g,
                                                     retain_graph=True), 2)
        del out, ins, g
        torch.cuda.empty_cache()
        shapes.append({"label": label, "shape": shape, "calls": calls,
                       "kernel_fwd_ms": fwd_ms, "function_bwd_ms": bwd_ms})
    return {"shapes": shapes, "function_bwd_ms_per_step": sum(
        r["calls"] * r["function_bwd_ms"] for r in shapes)}


def _lm_batches(cfg, seq: int, batch: int) -> dict:
    """Seeded ``LMClusterData`` batches of Markov tokens on the card, (K,
    B, seq) leaves, one a (round, cluster); an enc-dec model's also carry
    seeded random frames (K, B, enc_seq, d_model) in the compute dtype
    (the reference has no frames pipeline)."""
    import torch
    from repro_torch import streams
    from repro_torch.core.cpsl import to_device
    from repro_torch.data.pipeline import LMClusterData, batch_seed
    from repro_torch.data.synthetic import MarkovLM
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=0), LM_M * LM_K,
                         batch, seq, seed=0)
    gen = streams.sampler_generator(6, "cuda")
    out = {}
    for r in range(LM_ROUNDS):
        for m in range(LM_M):
            b = {k: to_device(a, "cuda") for k, a in data.cluster_batch(
                list(range(m * LM_K, (m + 1) * LM_K)),
                seed=batch_seed(0, r, m, 0)).items()}
            if cfg.encdec:
                b["frames"] = torch.randn(
                    (LM_K, batch, cfg.enc_seq, cfg.d_model), device="cuda",
                    generator=gen).to(getattr(torch, cfg.dtype))
            out[r, m] = b
    return out


def _fingerprint(state) -> list:
    """Per leaf of the state's ``dev`` and ``srv`` trees, an exact
    checksum of its bits weighted by position: the sum over elements of
    bits(x_i) * (2 i + 1) in wrapping int64, one a chunk of 2^22
    elements (None for an empty leaf; ~130 MB of transients at most). A
    change to one element changes it, and so do opposite changes to two:
    the K clients' copies of a device leaf start equal, and one ulp up in
    one copy with one ulp down in the other leaves sums of the values and
    of their squares as they were."""
    import torch
    from repro_torch import tree
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    out = []
    for t in tree.leaves({"dev": state["dev"], "srv": state["srv"]}):
        sums = []
        for i, c in enumerate(t.reshape(-1).split(1 << 22)):
            w = torch.arange(i << 22, (i << 22) + c.numel(), device=c.device,
                             dtype=torch.int64) * 2 + 1
            sums.append((c.view(bits[c.dtype]).long() * w).sum())
        out.append(torch.stack(sums) if t.numel() else None)
    return out


# a leaf must move in the first step when some element's SGD update |lr g|,
# less the gradient's measured run-to-run variation, is at least this many
# ulps of its value: an update over half an ulp always changes a
# round-to-nearest value, one under half an ulp is rounded away (a bf16
# norm scale of 1.0 keeps 1.0 unless |lr g| >= 2^-8), and the margin from
# half an ulp to one covers the rounding of lr g itself.
# ``_first_step_updates`` measures the variation as the largest
# |lr (g1 - g2)| of two gradients at the same state and batch, in ulps.
MOVE_ULPS = 1


def _first_step_updates(cp, state, batch) -> list:
    """For each parameter leaf (``dev`` then ``srv``, flatten order), the
    first step's SGD update from the gradient at that step's state and
    batch, computed twice: the leaf path, whether the batch reaches it (a
    nonzero gradient), the largest update in ulps of its element's value,
    max |lr g| / ulp(p), the two gradients' largest difference in the
    same ulps (``rerun_ulps``), whether the first less the second is at
    least MOVE_ULPS (``must_move``), the largest |lr g| and the largest
    |p|. Chunks of 2^26 elements bound the transients."""
    import torch
    from repro_torch import tree
    from repro_torch.core.cpsl import _value_and_grad
    grads = []
    for _ in range(2):
        _, (g_dev, g_srv) = _value_and_grad(
            cp._total_loss, (state["dev"], state["srv"]), batch)
        grads.append(tree.leaves({"dev": g_dev, "srv": g_srv}))
        del g_dev, g_srv
    lr = {"dev": cp.ccfg.lr_device, "srv": cp.ccfg.lr_server}
    precision = {torch.float32: 24, torch.bfloat16: 8}
    out = []
    for (path, p), g, g2 in zip(
            tree.flatten_with_path({"dev": state["dev"],
                                    "srv": state["srv"]}), *grads):
        if not p.numel():
            continue
        ulps, rerun, g_max = 0.0, 0.0, 0.0
        for pc, gc, gc2 in zip(p.reshape(-1).split(1 << 26),
                               g.reshape(-1).split(1 << 26),
                               g2.reshape(-1).split(1 << 26)):
            _, e = torch.frexp(pc.float())
            # the gradient that moves p by one ulp
            unit = torch.ldexp(torch.ones_like(pc, dtype=torch.float32),
                               e - precision[p.dtype]) / lr[path[0]]
            ulps = max(ulps, float((gc.float().abs() / unit).max()))
            rerun = max(rerun, float(((gc.float() - gc2.float()).abs()
                                      / unit).max()))
            g_max = max(g_max, float(gc.abs().max()))
        out.append({"leaf": "/".join(map(str, path)), "reached": g_max > 0,
                    "max_update_ulps": ulps, "rerun_ulps": rerun,
                    "must_move": ulps - rerun >= MOVE_ULPS,
                    "max_lr_g": lr[path[0]] * g_max,
                    "max_abs_p": float(p.abs().max())})
    del grads
    torch.cuda.empty_cache()
    return out


def lm_train_model(arch: str, smi: str) -> dict:
    """One model of the lm_train phase (see ``lm_train_phase``)."""
    import numpy as np
    import torch
    from repro_torch import streams, tree
    from repro_torch.configs import registry
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.profile import lm_profile
    from repro_torch.core.resource import saa_cut_selection
    from repro_torch.core.splitting import make_split_model
    from repro_torch.models import api
    start = time.perf_counter()
    spec = LM_MODELS[arch]
    seq, kernel, impl, plain = (spec["seq"], spec["kernel"], spec["impl"],
                                spec["plain"])
    batch = spec["batch"]
    full = registry.get(arch)
    cfg = full.replace(**{"dtype": "bfloat16", "param_dtype": "float32",
                          "remat": True, "loss_chunk": LM_LOSS_CHUNK,
                          **impl, **spec.get("cfg", {})})
    N = LM_M * LM_K
    saa_s, means = None, []
    if "cut" in spec:
        v = spec["cut"]
    else:
        t0 = time.perf_counter()
        n_cuts = full.n_enc_layers - 1 if full.encdec else 6
        v, means = saa_cut_selection(
            lm_profile(full, seq),
            NetworkCfg(n_devices=N, f_mean_range=(5e9, 50e9),
                       snr_mean_range_db=(15, 35)), B=batch, L=1,
            n_clusters=LM_M, cluster_size=LM_K, n_samples=2, gibbs_iters=40,
            cuts=range(1, n_cuts + 1))
        saa_s = time.perf_counter() - t0
    cp = CPSL(make_split_model(cfg, v), CPSLConfig(
        cut_layer=v, n_clusters=LM_M, cluster_size=LM_K, local_epochs=1,
        batch_per_device=batch))
    torch.cuda.reset_peak_memory_stats()
    state = cp.init_state(streams.model_generator(0, "cuda"))
    n_dev = sum(t[0].numel() for t in tree.leaves(state["dev"]))
    n_srv = sum(t.numel() for t in tree.leaves(state["srv"]))
    batches = _lm_batches(cfg, seq, batch)
    torch.cuda.synchronize()
    times = {"setup_s": time.perf_counter() - start}
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm_train {arch}: v = {v}" + (f" (SAA, {saa_s:.1f} s)" if saa_s
                                       else " (fixed)")
        + f"; {n_dev / 1e9:.3f} B device-side params a client, "
        f"{n_srv / 1e9:.3f} B server-side; init peak {init_peak_gb:.2f} GB")

    # the main path, with the kernels' counts read around it: 2 rounds of
    # CPSL.run_round; a step starts where batch_fn is called, and each
    # step's loss is kept (a device scalar) as cluster_step returns it.
    # The state's fingerprint before the first step and after it shows
    # which leaves that step moved; its time after the first step is
    # taken out of that step's time.
    counter = _launch_counter()
    marks, step_losses, rnd = [], [], 0
    cluster_step = cp.cluster_step
    t0 = time.perf_counter()
    updates = _first_step_updates(cp, state, batches[0, 0])
    times["first_step_updates_s"] = time.perf_counter() - t0
    moved = {"before": _fingerprint(state), "after_s": 0.0}

    def batch_fn(m, l):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return batches[rnd, m]

    def recording_step(state, batch, lr_scale=None):
        state, mt = cluster_step(state, batch, lr_scale=lr_scale)
        step_losses.append(mt["loss"])
        if "after" not in moved:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved["after"] = _fingerprint(state)
            torch.cuda.synchronize()
            moved["after_s"] = time.perf_counter() - t0
        return state, mt

    cp.cluster_step = recording_step
    torch.cuda.reset_peak_memory_stats()
    counter.reset()
    # run_round holds the only reference to the state it starts from, so
    # that state is freed after its first step (a reference kept here
    # would hold one more copy of the params: 16.8 GB for deepseek)
    held = [state]
    del state
    t0 = time.perf_counter()
    for rnd in range(LM_ROUNDS):
        held.append(cp.run_round(held.pop(), batch_fn)[0])
        marks.append(time.perf_counter())       # run_round synced the loss
    wall_s = time.perf_counter() - t0
    state = held.pop()
    launches = dict(counter)
    cp.cluster_step = cluster_step
    steps = LM_ROUNDS * LM_M
    step_ms = [1e3 * (marks[i + 1] - marks[i])
               for r in range(LM_ROUNDS)
               for i in range(r * (LM_M + 1), r * (LM_M + 1) + LM_M)]
    step_ms[0] -= 1e3 * moved["after_s"]
    losses = [float(x) for x in step_losses]
    expect = _lm_launches_per_step(cfg, kernel, v)
    other = [n for n in counter if n != kernel]
    if launches[kernel] != steps * expect or any(launches[n]
                                                 for n in other):
        raise AssertionError(f"{arch}: launches {launches} in {steps} "
                             f"steps; expected {expect} of {kernel} a step "
                             f"and none of {other}")
    # bf16 SGD can round a small update away, so a bf16-param model's
    # losses are reported, not held to fall
    falls = cfg.param_dtype != "bfloat16"
    if len(losses) != steps or not all(np.isfinite(losses)) or (
            falls and not losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: step losses {losses} not finite"
                             + (" and falling" if falls else ""))
    # every leaf is reached; every leaf with an update of MOVE_ULPS ulps
    # or more (past the re-run variation) moved in the first step; the
    # leaves that did not move are reported
    fp = [(a, b) for a, b in zip(moved["before"], moved["after"])
          if a is not None]
    for u, (a, b) in zip(updates, fp):
        u["moved"] = not torch.equal(a, b)
    bad = [u for u in updates
           if not u["reached"] or (u["must_move"] and not u["moved"])]
    if bad:
        raise AssertionError(f"{arch}: leaves not reached by the batch, or "
                             f"not moved by an update of {MOVE_ULPS} ulps "
                             f"or more: {bad}")
    unmoved = [u for u in updates if not u["moved"]]
    log(f"lm_train {arch}: {len(updates) - len(unmoved)} of {len(updates)} "
        f"parameter leaves moved in the first step; not moved: "
        f"{json.dumps(unmoved)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved_s = moved["after_s"]
    del moved

    # one step's forward and backward (the optimizer step aside), split
    # by the host clock, under one device profile
    split = {}

    def fwd_bwd(b=batches[0, 0]):
        dev_p = tree.map(lambda t: t.detach().requires_grad_(), state["dev"])
        srv_p = tree.map(lambda t: t.detach().requires_grad_(), state["srv"])
        t0 = time.perf_counter()
        with torch.enable_grad():
            total, _ = cp._total_loss(dev_p, srv_p, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.grad(total,
                                tree.leaves(dev_p) + tree.leaves(srv_p))
        torch.cuda.synchronize()
        split.update(fwd_ms=1e3 * (t1 - t0),
                     bwd_ms=1e3 * (time.perf_counter() - t1))

    t0 = time.perf_counter()
    prof = device_profile(fwd_bwd, host_ops=False)
    times["profile_s"] = time.perf_counter() - t0
    log(f"profile lm_train {arch} forward + backward: " + json.dumps(prof))

    # export and a short forward of the assembled model
    t0 = time.perf_counter()
    params, out_cfg = cp.export_params(state)
    del state
    b0 = batches[0, 0]
    fwd_batch = {"tokens": b0["tokens"][0, :1, :64]}
    if cfg.encdec:
        fwd_batch["frames"] = b0["frames"][0, :1]
    with torch.no_grad():
        logits, _ = api.forward(params, fwd_batch, out_cfg)
    if logits.shape != (1, fwd_batch["tokens"].shape[1], cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: exported forward {logits.shape}")
    del params, logits, batches, b0, fwd_batch
    torch.cuda.empty_cache()
    times["export_forward_s"] = time.perf_counter() - t0

    med = float(np.median(step_ms))
    t0 = time.perf_counter()
    kernel_bwd = _lm_kernel_bwd(cfg, kernel, v, seq, batch)
    times["kernel_bwd_s"] = time.perf_counter() - t0
    # the Functions' backwards of a step, each timed alone at its shape:
    # an estimate from the measured pieces
    kernel_bwd["recompute_share_of_step_est"] = (
        kernel_bwd["function_bwd_ms_per_step"] / med)
    t0 = time.perf_counter()
    grads = _lm_grad_check(full.replace(**spec.get("cfg", {}))
                           .replace(param_dtype="float32"),
                           kernel, impl, plain, seq)
    times["grad_check_s"] = time.perf_counter() - t0
    out = {
        "model": arch, "card": smi, "seq": seq, "v": v, "saa_s": saa_s,
        "saa_means_s": [float(x) for x in means],
        "layout": {"N": N, "M": LM_M, "K": LM_K, "B": batch, "L": 1,
                   "rounds": LM_ROUNDS, "steps": steps,
                   "n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
                   "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
                   "remat": True, "loss_chunk": LM_LOSS_CHUNK,
                   "optimizer": "sgd", "lr_device": cp.ccfg.lr_device,
                   "lr_server": cp.ccfg.lr_server},
        "params_b": {"device_per_client": n_dev / 1e9,
                     "server": n_srv / 1e9,
                     "trainable": (LM_K * n_dev + n_srv) / 1e9},
        "step_losses": losses, "wall_s": wall_s, "step_ms": step_ms,
        "step_ms_median": med, "step_split_ms": split,
        "device_busy_share": prof["busy_share"], "profile": prof,
        "init_peak_memory_gb": init_peak_gb, "peak_memory_gb": peak_gb,
        "launches_per_step": {n: c / steps for n, c in launches.items()},
        "launches_per_step_expected": expect, "kernel_bwd": kernel_bwd,
        "first_step": {"leaves": len(updates),
                       "moved": len(updates) - len(unmoved),
                       "move_ulps": MOVE_ULPS,
                       "rerun_max_ulps": max(u["rerun_ulps"]
                                             for u in updates),
                       "fingerprint_ms": 1e3 * moved_s,
                       "not_moved": unmoved},
        "grad_check": grads, "times": times,
        "phase_s": time.perf_counter() - start}
    if cfg.encdec:
        out["enc_seq"] = cfg.enc_seq
    log(f"lm_train {arch}: " + json.dumps(out))
    return out


def lm_train_phase(smi: str) -> dict:
    """Split-LM CPSL training at full width: gemma2-2b through K1 in every
    attention layer (S = 5120, past the 4096 window), mamba2-2.7b through
    K2 in every layer (S = 4096, train_4k's sequence), whisper-small with
    the cut inside the encoder (K1 at D = 64: the encoder's non-causal
    self-attention over 1500 frames, the decoder's causal self-attention
    over 448 tokens and its cross-attention over the frames; 4 clips a
    device), and deepseek-v2-lite-16b (MLA through K1 at D = 192, MoE, bf16
    params, DEEPSEEK_TRAIN_LAYERS of its 27 layers, v = 1, one 4096-token
    sequence a device); bf16 compute, remat on, random seeded weights,
    synthetic Markov tokens (and random frames for whisper). For each: the
    cut (SAA over cuts 1..6, or the encoder's, unless fixed), 2 rounds of
    ``CPSL.run_round`` on seeded batches (the counts read around them),
    one forward and backward under the profiler with their split,
    ``export_params`` and a forward of the assembled model, the kernel's
    forward against its Function's backward at each shape a step runs,
    and one block of each kind through the kernel path against the plain
    path.
    Then the launcher with ``--arch gemma2-2b --reduced --rounds 2``
    through ``CPSLTrainer`` and its checkpoint. Checks, none caught:
    finite step losses, falling where the params are f32; every
    parameter leaf reached by the first step, and moved where an update
    is MOVE_ULPS ulp or more of its value past the variation of a
    re-run gradient; each kernel's launches equal
    to ``_lm_launches_per_step`` a step and the other kernel's 0; the
    block gradients within LM_GRAD_TOL (a MoE block's plain path on the
    kernel path's routes); the launcher's losses finite."""
    import shutil

    import numpy as np
    from repro_torch.launch import train as tlaunch
    out = {arch: lm_train_model(arch, smi) for arch in LM_MODELS}
    ckpt = ROOT / "build" / "chip_smoke_ckpt" / "lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    hist = tlaunch.main(["--arch", "gemma2-2b", "--reduced", "--rounds",
                         "2", "--clusters", "2", "--cluster-size", "2",
                         "--ckpt-dir", str(ckpt)])
    shutil.rmtree(ckpt, ignore_errors=True)
    if [h["round"] for h in hist] != [0, 1] or not all(
            np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"launcher --arch gemma2-2b --reduced: {hist}")
    out["launcher_reduced_gemma2"] = {
        "wall_s": time.perf_counter() - t0,
        "losses": [h["loss"] for h in hist]}
    return out


# --------------------------------------------------------------------------
# 10. sim: the wireless-dynamics simulator (no hand-written kernel)
# --------------------------------------------------------------------------

# benchmarks/bench_simfleet.py: the paper's N = 30, C = 30, K = 5, cut 3,
# B = 16, L = 1, LeNet profile
SIM_NET = dict(n_devices=30, n_subcarriers=30)
SIM_GRID = dict(seeds=tuple(range(8)), cluster_sizes=(5,), cuts=(3,),
                batch_per_device=16, local_epochs=1)
SIM_BENCH = dict(rounds=150, policies=("greedy", "equal"))
SIM_BENCH_DYN = dict(rho_snr=0.9, rho_f=0.95, seed=0,
                     forced_departures={5: (2,), 12: (7, 9)},
                     energy_budget_j=400.0)
SIM_PROPOSED = dict(rounds=60, policies=("proposed",), epoch_len=10,
                    gibbs_iters=25, gibbs_chains=1, saa_samples=2,
                    saa_gibbs_iters=12, saa_cuts=(1, 2, 3), n_reserve=2,
                    min_devices_floor=True)
SIM_PROPOSED_DYN = dict(rho_snr=0.9, rho_f=0.95, seed=0, p_depart=0.02,
                        p_arrive=0.1, min_devices=4, energy_budget_j=400.0)
FIG7_RUNS = 300                    # benchmarks/fig7_cut_layer.py, full mode
FIG7_SAMPLE = 24                   # episodes checked against run_reference
SIM_RTOL = 1e-9                    # bench_simfleet: fleet vs looped host
SIM_RECOMPUTE_RTOL = 1e-12         # bench_simfleet: vs the NumPy oracle
SIM_TRACE_TOL = 1e-6               # examples/dynamics_sim.py
SIM_DECISIONS = ("dev", "mask", "csize", "xs", "v", "active", "n_active")


def _sim_rel(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _sim_against_reference(runner, res, episodes) -> dict:
    """Each episode of a card ``run`` against the port's looped NumPy
    ``run_reference``: identical cut, cluster and allocation decisions
    every slot, latencies within SIM_RTOL."""
    from repro_torch.sim.fleet import fleet_trace_records
    worst, t0 = 0.0, time.perf_counter()
    for e in episodes:
        want = runner.run_reference(e)
        got = fleet_trace_records(res, e)
        for t, (g, w) in enumerate(zip(got, want)):
            same = (g["v"] == w["v"] and g["clusters"] == w["clusters"]
                    and len(g["xs"]) == len(w["xs"])
                    and all((a == b).all() for a, b in zip(g["xs"],
                                                           w["xs"])))
            if not same:
                raise AssertionError(f"sim: episode {e} slot {t}: card "
                                     "decision differs from run_reference")
        worst = max(worst, _sim_rel([g["latency_s"] for g in got],
                                    [w["latency_s"] for w in want]))
    if worst > SIM_RTOL:
        raise AssertionError(f"sim: latency vs run_reference {worst:.3e}")
    return {"episodes_checked": len(episodes), "max_rel_err": worst,
            "wall_s": time.perf_counter() - t0}


def _sim_fleet_case(label: str, build, smi: str, profile_slots: int,
                    cpu_check: bool = True, sample=None) -> dict:
    """One grid on the card: two ``run``s (the first pays the allocator's
    warm-up) and their peak memory; the busy share from a device profile
    of the same grid cut to its first ``profile_slots`` slots (every slot
    runs the same kernels, and a trace of ~10^6 launches takes minutes to
    read); every episode (or ``sample``) against ``run_reference``; the
    recompute oracle; the same runner on the CPU with identical
    decisions."""
    import numpy as np
    import torch
    from repro_torch.sim.engine import recompute_trace_latencies
    runner = build("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = runner.run()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = runner.run()
    second = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    E, T = runner.E, runner.T
    for k in SIM_DECISIONS:
        if not np.array_equal(res["trace"][k], res2["trace"][k]):
            raise AssertionError(f"sim {label}: two card runs differ in {k}")
    t0 = time.perf_counter()
    prof = device_profile(build("cuda", profile_slots).run, host_ops=False)
    out = {"card": smi, "episodes": E, "slots": T,
           "profiled_slots": profile_slots,
           "profile_s": time.perf_counter() - t0,
           "first_run_s": first, "second_run_s": second,
           "run_wall_s": res2["wall_s"],
           "episode_slots_per_s": E * T / second,
           "device_profile": prof, "busy_share": prof["busy_share"],
           "peak_mem_bytes": int(peak)}
    log(f"sim {label}: E = {E} x T = {T}: run {first:.2f} s, then "
        f"{second:.2f} s ({E * T / second:.0f} episode-slots/s), busy "
        f"{100 * prof['busy_share']:.1f} %, peak {peak / 2**20:.1f} MiB")
    episodes = range(E) if sample is None else sample
    out["vs_run_reference"] = _sim_against_reference(runner, res, episodes)
    want = recompute_trace_latencies(res, runner.prof, runner.ncfg,
                                     runner.fcfg.batch_per_device,
                                     runner.fcfg.local_epochs)
    out["recompute_rel_err"] = _sim_rel(res["trace"]["latency"], want)
    if out["recompute_rel_err"] > SIM_RECOMPUTE_RTOL:
        raise AssertionError(f"sim {label}: recompute "
                             f"{out['recompute_rel_err']:.3e}")
    xs, mask = res["trace"]["xs"], res["trace"]["mask"]
    sums = np.where(mask, xs, 0).sum(axis=-1)
    if not (sums[res["trace"]["csize"] > 0]
            == runner.ncfg.n_subcarriers).all():
        raise AssertionError(f"sim {label}: spectrum budget violated")
    if cpu_check:
        cpu = build("cpu")
        t0 = time.perf_counter()
        cres = cpu.run()
        out["cpu_run_s"] = time.perf_counter() - t0
        for k in SIM_DECISIONS:
            if not np.array_equal(res["trace"][k], cres["trace"][k]):
                bad = np.argwhere((res["trace"][k] != cres["trace"][k])
                                  .reshape(E, T, -1).any(-1))[:3].tolist()
                raise AssertionError(f"sim {label}: card and CPU differ in "
                                     f"{k} at (episode, slot) {bad}")
        out["cpu_max_rel_err"] = max(
            _sim_rel(res["trace"][k], cres["trace"][k])
            for k in ("latency", "cluster_latency", "energy", "f", "rate"))
        if out["cpu_max_rel_err"] > SIM_RTOL:
            raise AssertionError(f"sim {label}: card vs CPU "
                                 f"{out['cpu_max_rel_err']:.3e}")
    out["mean_latency_s"] = float(np.mean(res["trace"]["latency"]))
    return out, res


def sim_phase(smi: str) -> dict:
    """The wireless-dynamics simulator of ``repro_torch.sim`` on the card,
    at the sizes its benchmarks run:

    (a) bench_simfleet's grid at the paper's size (N = C = 30, K = 5, cut
        3, B = 16, L = 1): greedy and equal arms over 8 seeds x 150 slots
        with forced departures and 400 J batteries; the proposed arm
        (Gibbs + greedy every slot, SAA over cuts 1-3 every 10 slots,
        Bernoulli churn with the floor, 2 reserve arrivals) over 8 seeds
        x 60 slots. Every episode equals the port's looped
        ``run_reference`` in decisions and within SIM_RTOL; the recompute
        oracle within SIM_RECOMPUTE_RTOL; a CPU run of the same runner
        makes the same decisions.
    (b) fig. 7's Monte-Carlo grid: 300 runs x every LeNet cut, one slot,
        greedy, i.i.d. draws (rho = 0) of the seed-0 population, each
        run's random clustering keyed by its seed; FIG7_SAMPLE episodes
        against ``run_reference``.
    (c) ``SimEngine`` on examples/dynamics_sim.py's configuration: LeNet
        trained on the card, 30 devices, 8 rounds; its trace recomputes
        within SIM_TRACE_TOL.

    Neither hand-written kernel runs on this path: both counts must read
    0 after it."""
    import json as _json

    import numpy as np
    import torch
    from repro_torch import streams
    from repro_torch.configs.base import CPSLConfig, SimCfg, SimFleetCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.data.pipeline import CPSLDataset
    from repro_torch.models import lenet
    from repro_torch.models.lenet import LAYERS
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.engine import SimEngine, recompute_trace_latencies
    from repro_torch.sim.fleet import SimFleetRunner

    prof = lenet_profile()
    counter = _launch_counter()
    counter.reset()
    t_phase = time.perf_counter()
    out = {"card": smi}

    def fleet(grid, dyn, net=SIM_NET, **kw):
        def build(device, rounds=None):
            g = dict(SIM_GRID, **grid)
            if rounds:
                g["rounds"] = rounds
            return SimFleetRunner(prof, NetworkCfg(**net),
                                  DynamicsCfg(**dyn), SimFleetCfg(**g),
                                  device=device, **kw)
        return build

    out["bench"], _ = _sim_fleet_case(
        "bench (greedy, equal)", fleet(SIM_BENCH, SIM_BENCH_DYN), smi, 15)
    out["proposed"], res = _sim_fleet_case(
        "proposed", fleet(SIM_PROPOSED, SIM_PROPOSED_DYN), smi, 5)
    out["proposed"]["cuts_chosen"] = sorted(
        int(v) for v in np.unique(res["trace"]["v"]))

    # (b) fig. 7
    cuts = tuple(range(1, prof.n_cuts + 1))
    rng = np.random.default_rng(0)
    perms = {s: rng.permutation(30) for s in range(FIG7_RUNS)}
    fig7 = fleet(dict(rounds=1, seeds=tuple(range(FIG7_RUNS)),
                      policies=("greedy",), cuts=cuts, mean_seed=0),
                 dict(rho_snr=0.0, rho_f=0.0, seed=0),
                 net=dict(n_devices=30), perms=perms)
    E7 = FIG7_RUNS * len(cuts)
    out["fig7"], res7 = _sim_fleet_case(
        "fig7", fig7, smi, 1, cpu_check=False,
        sample=list(range(0, E7, E7 // FIG7_SAMPLE)))
    lat = np.asarray(res7["trace"]["latency"])[:, 0].reshape(len(cuts),
                                                            FIG7_RUNS)
    out["fig7"]["mean_latency_by_cut"] = lat.mean(axis=1).tolist()
    out["fig7"]["p95_latency_by_cut"] = np.percentile(lat, 95,
                                                      axis=1).tolist()
    best = int(np.argmin(lat.mean(axis=1))) + 1
    out["fig7"]["optimal_cut"] = [best, LAYERS[best - 1]]

    # (c) SimEngine, examples/dynamics_sim.py's configuration
    xtr, ytr, xte, yte, idx = _train_data()
    ds = CPSLDataset(xtr, ytr, idx, batch=16)
    ncfg = NetworkCfg(n_devices=30)
    ccfg = CPSLConfig(cluster_size=5, local_epochs=1, batch_per_device=16)
    trace_path = ROOT / "build" / "chip_smoke_sim_trace.jsonl"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    scfg = SimCfg(rounds=8, epoch_len=4, cluster_size=5, saa_samples=2,
                  saa_gibbs_iters=20, gibbs_iters=60, gibbs_chains=4,
                  cuts=(2, 3, 4), trace_path=str(trace_path), seed=0)
    dcfg = DynamicsCfg(rho_snr=0.9, rho_f=0.95, forced_departures={2: (7,)},
                       p_arrive=0.25, min_devices=10, energy_budget_j=500.0,
                       seed=0)
    xte_d = torch.as_tensor(xte, device="cuda")
    yte_d = torch.as_tensor(yte, device="cuda")

    def eval_fn(cp, state):
        params, _ = cp.export_params(state)
        return lenet.accuracy(params, xte_d, yte_d)

    eng = SimEngine("lenet", ds, prof, ncfg, dcfg, scfg, ccfg,
                    eval_fn=eval_fn, device="cuda")
    holder = {}

    def run_engine():
        holder["trace"] = eng.run(streams.model_generator(0, "cuda"))[1]

    eprof = device_profile(run_engine, host_ops=False)
    trace = holder["trace"]
    lines = [_json.loads(x) for x in trace_path.read_text().splitlines()]
    rounds = [r for r in lines if not r.get("skipped")]
    want = recompute_trace_latencies(lines, prof, ncfg, 16, 1)
    err = float(np.abs(np.array([r["latency_s"] for r in rounds])
                       - want).max())
    if err >= SIM_TRACE_TOL:
        raise AssertionError(f"sim engine: trace recompute error {err}")
    losses = [r["loss"] for r in rounds]
    if not np.isfinite(losses).all():
        raise AssertionError(f"sim engine: losses {losses}")
    out["engine"] = {
        "card": smi, "rounds": len(trace), "recompute_err": err,
        "rounds_s": eng.timings, "losses": losses,
        "acc": [r["eval"] for r in rounds],
        "cuts": [r["v"] for r in rounds],
        "events": sum(len(r["events"]) for r in lines),
        "stale_rounds": sum(bool(r.get("stale")) for r in rounds),
        "wall_s": eprof["wall_ms"] / 1e3, "busy_share": eprof["busy_share"],
        "device_profile": eprof}
    for t in eng.timings:
        log(f"sim engine round {t['round']}: wall {t['wall_ms']:.1f} ms, "
            f"plan {t['plan_ms']:.1f} ms, train {t['train_ms']:.1f} ms")
    log(f"sim engine: losses {[round(x, 3) for x in losses]}, recompute "
        f"err {err:.1e}, busy {100 * eprof['busy_share']:.1f} %")

    out["hand_kernel_launches"] = dict(counter)
    if any(out["hand_kernel_launches"].values()):
        raise AssertionError("sim: a hand-written kernel ran: "
                             + _json.dumps(out["hand_kernel_launches"]))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# arXiv:2204.08119 §VIII-A at PERF.md §4's LeNet sizes (as train_phase):
# 30 device worker processes, 6 clusters of 5, B = 16, cut 3, L = 1
RT_PAPER = dict(n_devices=30, cluster_size=5, rounds=2, cut=3,
                local_epochs=1, batch=16, n_train=8000, n_test=1500,
                classes_per_device=3, samples_per_device=180, seed=0)
# examples/rt_loopback.py's deployment: eq. 15-25 delays injected at 0.05,
# device 3's round-1 model upload dropped
RT_EXAMPLE = dict(n_devices=4, cluster_size=2, rounds=3, local_epochs=1,
                  batch=8, n_train=600, n_test=64, samples_per_device=80,
                  seed=0, delay_scale=0.05, phase_timeout_s=6.0,
                  rpc_timeout_s=1.0, retries=2, backoff_s=0.2)
# its --chaos drill
RT_CHAOS = dict(n_devices=2, cluster_size=2, rounds=3, local_epochs=1,
                batch=4, n_train=400, n_test=64, samples_per_device=60,
                seed=0, phase_timeout_s=60.0, rejoin_timeout_s=60.0,
                reconnect_timeout_s=60.0, respawn=True, reconnect=True,
                cluster_retries=2)
RT_QOS_PHASES = ("fwd", "grad_wait", "bwd", "server", "upload", "model_up")


def _rt_bit_equal(label: str, got, want):
    import torch
    from repro_torch import tree
    for key in ("dev", "dev_opt", "srv", "srv_opt", "step"):
        for a, b in zip(tree.leaves(got[key]), tree.leaves(want[key]),
                        strict=True):
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(a, b):
                raise AssertionError(
                    f"rt {label}: {key} differs from loopback_reference")


class _SmiSampler:
    """The card's memory in use per ``nvidia-smi`` (every process's
    context and allocations, which ``max_memory_allocated`` of one
    process does not see), sampled every ``every`` s in a thread."""

    def __init__(self, every: float = 1.0):
        import threading
        self.every, self.mib = every, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=30).stdout
            self.mib.append(float(out.splitlines()[0]))
            if self._stop.wait(self.every):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def rt_phase(smi: str) -> dict:
    """The CPSL deployment runtime (``repro_torch.rt``) on the card: real
    device-worker processes, each its own CUDA context, and a server in
    this process, over localhost sockets.

    (a) RT_PAPER, the paper's configuration as a deployment: 30 workers,
        6 clusters of 5 in sequence, 2 rounds. The final dev, dev_opt,
        srv, srv_opt and step must equal the port's ``loopback_reference``
        on the card bit for bit (deterministic cuDNN, no TF32, in every
        process). Seconds to all-READY (spawn, import torch, CUDA init,
        warm-up), wall seconds per round, the median QoS seconds per
        phase, the server's peak memory, the card's memory in use per
        nvidia-smi, and the hand kernels' launches in this (the server's)
        process, which must be 0.
    (b) RT_EXAMPLE: round 1 must drop exactly device 3, rounds 0 and 2
        nobody; ``crossval_report``'s summary.
    (c) RT_CHAOS under ``chaos_schedule(seed=7, kill_workers=1,
        kill_server=1)`` through ``run_elastic`` with a WAL in a temporary
        directory: every round recorded, nobody dropped, the final state
        bit-equal to ``loopback_reference``; the restarts (server resumes
        and recovered workers) and the wall seconds."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.rt.crossval import crossval_report
    from repro_torch.rt.faults import FaultRule, chaos_schedule
    from repro_torch.rt.orchestrator import (Orchestrator, RTConfig,
                                             loopback_reference,
                                             run_elastic, run_loopback)
    from repro_torch.rt.protocol import MsgType

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()         # earlier phases' cached blocks
    out = {"card": smi}
    counter = _launch_counter()

    def rounds_of(records):
        return [r for r in records if r.get("kind") != "qos"]

    # (a) the paper's configuration
    cfg = RTConfig(device="cuda", **RT_PAPER)
    counter.reset()
    torch.cuda.reset_peak_memory_stats()
    orch = Orchestrator(cfg)
    with _SmiSampler() as smi_mem:
        t0 = time.perf_counter()
        try:
            orch.start()
            ready_s = time.perf_counter() - t0
            state, records = orch.run()
        finally:
            orch.stop()
        total_s = time.perf_counter() - t0
    launches = dict(counter)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ref, ref_loss = loopback_reference(cfg)
    _rt_bit_equal("paper", state, ref)
    rounds = rounds_of(records)
    if [r["dropped"] for r in rounds] != [[]] * cfg.rounds \
            or rounds[-1]["loss"] != ref_loss:
        raise AssertionError(f"rt paper: rounds {rounds}")
    if any(launches.values()):
        raise AssertionError(f"rt: a hand-written kernel ran: {launches}")
    qos = [q for q in records if q.get("kind") == "qos"]
    out["paper"] = {
        "card": smi, "config": RT_PAPER, "bit_equal": True,
        "ready_s": ready_s, "run_s": total_s,
        "round_wall_s": [r["wall_s"] for r in rounds],
        "losses": [r["loss"] for r in rounds],
        "qos_median_s": {ph: float(np.median([q["t_s"] for q in qos
                                              if q["phase"] == ph]))
                         for ph in RT_QOS_PHASES},
        "qos_n": {ph: sum(q["phase"] == ph for q in qos)
                  for ph in RT_QOS_PHASES},
        # each worker's startup before READY: the data build, and the
        # warm-up that creates its CUDA context
        "startup_median_s": {ph: float(np.median([q["t_s"] for q in qos
                                                  if q["phase"] == ph]))
                             for ph in ("data", "warmup")},
        "server_peak_gb": peak_gb,
        "card_mem_used_mib_max": max(smi_mem.mib),
        "card_mem_used_mib_samples": len(smi_mem.mib),
        "hand_kernel_launches": launches}
    log(f"rt paper: ready {ready_s:.1f} s, rounds "
        f"{[round(r['wall_s'], 3) for r in rounds]} s, bit-equal, card "
        f"memory up to {max(smi_mem.mib):.0f} MiB")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the example's deployment with its fault round
        cfg = RTConfig(device="cuda", trace_path=f"{tmp}/example.jsonl",
                       faults={3: [FaultRule(
                           "drop", msg_types=(int(MsgType.AGG),),
                           rounds=(1,))]}, **RT_EXAMPLE)
        t0 = time.perf_counter()
        _, records = run_loopback(cfg)
        wall = time.perf_counter() - t0
        rounds = rounds_of(records)
        if [r["dropped"] for r in rounds] != [[], [3], []]:
            raise AssertionError(f"rt example: dropped "
                                 f"{[r['dropped'] for r in rounds]}")
        out["example"] = {
            "card": smi, "wall_s": wall,
            "dropped": [r["dropped"] for r in rounds],
            "round_wall_s": [r["wall_s"] for r in rounds],
            "predicted_s": [r["latency_s"] * cfg.delay_scale
                            for r in rounds],
            "crossval": crossval_report(records)["summary"]}

        # (c) the chaos drill
        plan = chaos_schedule(seed=7, rounds=RT_CHAOS["rounds"],
                              n_devices=RT_CHAOS["n_devices"],
                              kill_workers=1, kill_server=1)
        cfg = RTConfig(device="cuda", faults=plan.worker_faults,
                       chaos_kill_server=plan.server_kill_rounds,
                       wal_dir=f"{tmp}/wal", trace_path=f"{tmp}/chaos.jsonl",
                       **RT_CHAOS)
        t0 = time.perf_counter()
        state, records = run_elastic(cfg)
        wall = time.perf_counter() - t0
        ref, _ = loopback_reference(cfg)
        _rt_bit_equal("chaos", state, ref)
        rounds = rounds_of(records)
        if [r["round"] for r in rounds] != list(range(cfg.rounds)) \
                or any(r["dropped"] for r in rounds):
            raise AssertionError(f"rt chaos: rounds {rounds}")
        resumes = [q for q in records if q.get("kind") == "qos"
                   and q["phase"] == "resume"]
        out["chaos"] = {
            "card": smi, "events": plan.events, "wall_s": wall,
            "bit_equal": True,
            "server_restarts": len(resumes),
            "resume_s": [q["t_s"] for q in resumes],
            "workers_recovered": sorted(
                g for r in rounds for g in r["recovered"])}
    log(f"rt example: dropped {out['example']['dropped']}; chaos: "
        f"{out['chaos']['server_restarts']} server restart(s), workers "
        f"{out['chaos']['workers_recovered']} recovered, "
        f"{out['chaos']['wall_s']:.1f} s, bit-equal")
    out["hand_kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------------------
# 12. launch: the dry run, the roofline and the analysis on the card
# --------------------------------------------------------------------------

# (a) runs the dry run's whole table through the kernels' meta paths
DRYRUN_OVERRIDES = ("attn_impl=pallas", "ssd_impl=pallas")
LAUNCH_OUT = ROOT / "build" / "chip_smoke"   # records and the report
DRYRUN_OUT = LAUNCH_OUT / "dryrun"
CARD_GB = 80.0                     # one H100's device memory
LAUNCH_REPS = 3                    # timed runs of each (b) step


def start_dryrun_table():
    """(a), started right after the kernels build: ``python -m
    repro_torch.launch.dryrun --all --mesh h100`` in a process of its own.
    It traces every cell on ``meta`` (host CPU only), so it runs beside the
    card phases; ``launch_phase`` waits for it. Returns (process, log
    path, start time on the wall clock)."""
    import os
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    for old in DRYRUN_OUT.glob("*.json"):
        old.unlink()
    logf = DRYRUN_OUT / "dryrun.log"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
           "--mesh", "h100", "--out", str(DRYRUN_OUT)]
    for ov in DRYRUN_OVERRIDES:
        cmd += ["--override", ov]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(logf, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)
    return proc, logf, time.time()


def _dryrun_table(proc, logf, t0) -> dict:
    """(a)'s result: one line per cell, read from the records; ``wall_s``
    runs from the process's start to its last record."""
    rc = proc.wait(timeout=900)
    if rc != 0:
        log(logf.read_text()[-4000:])
        raise AssertionError(f"dry-run table: exit {rc}")
    records = sorted(DRYRUN_OUT.glob("*__h100.json"))
    wall = max(fn.stat().st_mtime for fn in records) - t0
    rows = []
    for fn in records:
        rec = json.loads(fn.read_text())
        peak = rec["memory"]["peak_bytes_per_device"] / 1e9
        rl = rec["roofline"]
        rows.append({"arch": rec["arch"], "cell": rec["cell"],
                     "peak_gb": peak, "fits": peak <= CARD_GB,
                     "compute_ms": 1e3 * rl["compute_s"],
                     "memory_ms": 1e3 * rl["memory_s"],
                     "bottleneck": rl["bottleneck"],
                     "model_flops": rl["model_flops"],
                     "counted_flops": rl["hlo_flops_global"],
                     "useful_ratio": rl["useful_ratio"],
                     "custom_calls": rec["custom_calls"],
                     "trace_s": rec["lower_s"]})
        r = rows[-1]
        log(f"dryrun {r['arch']:22s} {r['cell']:12s} peak "
            f"{peak:8.2f} GB {'fits' if r['fits'] else 'DOES NOT FIT'}; "
            f"compute {r['compute_ms']:9.2f} ms, memory "
            f"{r['memory_ms']:9.2f} ms -> {r['bottleneck']}; model_flops "
            f"{r['model_flops']:.4g}, useful {r['useful_ratio']:.3f}; "
            f"trace {r['trace_s']} s")
    want = 32
    if len(rows) != want:
        raise AssertionError(f"dry-run table: {len(rows)} records, "
                             f"{want} cells")
    return {"cells": rows, "wall_s": wall,
            "trace_s": sum(r["trace_s"] for r in rows),
            "fit": sum(r["fits"] for r in rows)}


def _launch_steps():
    """(b)'s three steps: (label, builder(device) -> (step, args), cfg,
    shape, kernel, expected launches)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cuda")
    gemma = registry.get("gemma2-2b").replace(attn_impl="pallas")
    mamba = registry.get("mamba2-2.7b").replace(ssd_impl="pallas")
    # lm_train_phase's setting: bf16 compute, f32 params, remat, the CE in
    # LM_LOSS_CHUNK tokens, SGD at the CPSLConfig lrs, v = 1, K = LM_K
    train = gemma.replace(dtype="bfloat16", param_dtype="float32",
                          remat=True, loss_chunk=LM_LOSS_CHUNK)
    s_gemma = ShapeCfg("gemma2_prefill", PROMPT, BATCH, "prefill")
    s_mamba = ShapeCfg("mamba2_prefill", MAMBA_PROMPT, BATCH, "prefill")
    s_train = ShapeCfg("gemma2_train_step", PROMPT, LM_K * LM_B, "train")
    return [
        ("gemma2-2b prefill", lambda d: dryrun.build_prefill(
            gemma, s_gemma, mesh, device=d), gemma, s_gemma,
         "flash_attention", len(gemma.layer_specs())),
        ("mamba2-2.7b prefill", lambda d: dryrun.build_prefill(
            mamba, s_mamba, mesh, device=d), mamba, s_mamba, "ssd",
         len(mamba.layer_specs())),
        ("gemma2-2b training step", lambda d: dryrun.build_train(
            train, s_train, mesh, 1, LM_K,
            ccfg_over=["optimizer=sgd", "lr_device=0.05",
                       "lr_server=0.25"], device=d), train, s_train,
         "flash_attention", _lm_launches_per_step(train, "flash_attention",
                                                  1)),
    ]


def _launch_step(label, build, cfg, shape, kernel, expect, smi) -> dict:
    """One (b) step: counted on meta (the estimate), then built on the card
    and counted as it runs (the kernels' counts set to 0 just before and
    read just after), then timed without the counter."""
    import torch
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.roofline import roofline_terms
    counter = _launch_counter()
    step, args = build("meta")
    t0 = time.perf_counter()
    est, _ = hlo_analysis.analyze(step, *args)
    meta_s = time.perf_counter() - t0
    del step, args
    step, args = build("cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counter.reset()
    t0 = time.perf_counter()
    run, out = hlo_analysis.analyze(step, *args)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(counter)
    measured_peak = torch.cuda.max_memory_allocated() - before
    del out
    times = []
    for _ in range(LAUNCH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    del step, args
    torch.cuda.empty_cache()
    step_s = sorted(times)[len(times) // 2]
    rl = roofline_terms(hlo_analysis.report(run), 1, cfg, shape)
    bound_s = max(rl.compute_s, rl.memory_s)
    est_step = est.peak_bytes - est.argument_bytes
    rec = {"flops": {"meta": est.flops, "card": run.flops},
           "hbm_bytes": {"meta": est.hbm_bytes, "card": run.hbm_bytes},
           "custom_calls": {"meta": dict(est.custom_calls),
                            "card": dict(run.custom_calls)},
           "launches": launches,
           "argument_gb": est.argument_bytes / 1e9,
           "peak_gb_estimate": est.peak_bytes / 1e9,
           "step_peak_gb_estimate": est_step / 1e9,
           "step_peak_gb_measured": measured_peak / 1e9,
           "peak_ratio": est_step / measured_peak,
           "compute_ms": 1e3 * rl.compute_s, "memory_ms": 1e3 * rl.memory_s,
           "bottleneck": rl.bottleneck, "model_flops": rl.model_flops,
           "useful_ratio": rl.useful_ratio,
           "step_ms": 1e3 * step_s, "step_ms_all": [1e3 * t for t in times],
           "roofline_share": bound_s / step_s, "meta_trace_s": meta_s,
           "counted_run_s": counted_s, "card": smi}
    log(f"launch {label}: FLOPs meta {est.flops:.6g} card {run.flops:.6g}; "
        f"bytes meta {est.hbm_bytes:.6g} card {run.hbm_bytes:.6g}; custom "
        f"calls {dict(run.custom_calls)}, launches {launches}; step peak "
        f"est {est_step / 1e9:.3f} GB vs measured {measured_peak / 1e9:.3f} "
        f"GB (ratio {rec['peak_ratio']:.3f}); step {1e3 * step_s:.2f} ms, "
        f"roofline {1e3 * bound_s:.2f} ms ({rl.bottleneck}) = "
        f"{100 * rec['roofline_share']:.1f} % of the step [{smi}]")
    if est.flops != run.flops or est.hbm_bytes != run.hbm_bytes:
        raise AssertionError(f"{label}: meta and card counts differ")
    other = [k for k in counter if k != kernel]
    if (dict(run.custom_calls) != {kernel: expect}
            or dict(est.custom_calls) != {kernel: expect}
            or launches[kernel] != expect
            or any(launches[k] for k in other)):
        raise AssertionError(f"{label}: custom calls {rec['custom_calls']}, "
                             f"launches {launches}, expected {expect}")
    return rec


def _analysis_check() -> dict:
    """(c): the analysis gate on the card, in a process of its own."""
    import os
    out = LAUNCH_OUT / "ANALYSIS.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--out",
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    log(res.stdout.strip()[-2000:])
    if res.returncode != 0:
        log(res.stderr[-4000:])
        raise AssertionError(f"analysis --check: exit {res.returncode}")
    rep = json.loads(out.read_text())
    if rep["jit_checks_run"] != ["JIT002", "JIT003"] or len(
            rep["jit_targets"]) != 4:
        raise AssertionError(f"analysis --check ran {rep}")
    return {"rc": res.returncode, "n_findings": rep["n_findings"],
            "jit_checks_run": rep["jit_checks_run"],
            "jit_targets": rep["jit_targets"],
            "not_applicable": sorted(rep["not_applicable"]),
            "wall_s": wall}


def launch_phase(smi: str, table) -> dict:
    """The dry run, the roofline and the analysis (``repro_torch.launch``,
    ``repro_torch.analysis``) on the card.

    (a) The dry run's whole table, 10 arches x their cells (32), built
        and traced on ``meta`` with the kernels' meta paths
        (``start_dryrun_table``): per cell the peak GB of one card and
        whether it fits 80 GB, the compute and memory terms and the
        bottleneck, MODEL_FLOPS and the useful ratio, the trace's seconds.
        A failing cell fails the phase.
    (b) Three steps the card runs, each built by the dry run's builders
        once on ``meta`` (the estimate) and once on the card (the run),
        under the same op counter: gemma2-2b prefill (batch 4, prompt
        5120, K1 26 times), mamba2-2.7b prefill (batch 4, 8192 tokens, K2
        64 times) and one split training step of gemma2-2b at
        lm_train_phase's setting (v = 1, K = 2, B = 2, S = 5120, K1 under
        its autograd.Function). Meta and card FLOPs and HBM bytes must be
        equal, and the custom calls equal to the kernel's launches. The
        peak estimate (less the arguments) against max_memory_allocated
        over the step (less what was allocated before), and the measured
        step time against the roofline's max(compute, memory).
    (c) ``python -m repro_torch.analysis --check`` (rng_lint, thread_lint,
        JIT002 under sync-debug "error" and JIT003 on the four targets)
        with the empty baseline must exit 0."""
    t_phase = time.perf_counter()
    out = {"card": smi}
    out["steps"] = {}
    for label, build, cfg, shape, kernel, expect in _launch_steps():
        out["steps"][label] = _launch_step(label, build, cfg, shape, kernel,
                                           expect, smi)
    out["table"] = _dryrun_table(*table)
    log(f"dryrun table: {out['table']['fit']} of 32 cells fit {CARD_GB} GB; "
        f"traces {out['table']['trace_s']:.1f} s, wall "
        f"{out['table']['wall_s']:.1f} s beside the card phases")
    out["analysis"] = _analysis_check()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def device_profile(fn, top: int = 8, host_ops: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler: its host wall time, the
    device time summed over the kernels it ran (one stream, so the sum is
    the busy time), the busy share of the wall time, and the ``top``
    kernels by device time. ``host_ops=False`` traces the card alone:
    for a call of ~10^5 kernel launches, tracing the host's ops too costs
    minutes of post-processing and adds host time to every op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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

    t_start = time.perf_counter()
    smi = device_phase()["nvidia_smi"]
    table = start_dryrun_table()
    try:
        return _main(torch, t_start, smi, table)
    finally:
        if table[0].poll() is None:
            table[0].kill()
            table[0].wait()


def _main(torch, t_start, smi, table) -> int:
    k1_build = flash_bf16_build_check()
    k2_build = ssd_build_check()
    sweep = flash_sweep()
    shapes = flash_slice_shapes()
    moe_shapes = flash_moe_shapes()
    whisper_shapes = flash_whisper_shapes()
    ssd_worst = ssd_sweep()
    ssd_rows = ssd_shapes()
    ssd_jamba = ssd_jamba_shape()
    ssd_short = ssd_short_chunks()
    gemma = gemma_serve_phase()
    mamba = mamba_serve_phase()
    moe = moe_serve_phase()
    whisper = whisper_serve_phase()
    train = train_phase()
    fleet = fleet_phase(train, smi)
    lm_train = lm_train_phase(smi)
    sim = sim_phase(smi)
    rt = rt_phase(smi)
    launch = launch_phase(smi, table)

    def launches(name):
        """The kernel's launches in each main path's run, each counted
        from 0 just before that run and read just after it."""
        out = {f"{r['model']} generate": r["launches_per_generate"][name]
               for r in (gemma, mamba, *(moe[a] for a in MOE_MODELS),
                         whisper)}
        for arch, r in lm_train.items():
            if isinstance(r, dict) and "launches_per_step" in r:
                out[f"{arch} training step"] = int(
                    r["launches_per_step"][name])
        out["sim phase"] = sim["hand_kernel_launches"][name]
        out["rt phase"] = rt["hand_kernel_launches"][name]
        for label, r in launch["steps"].items():
            out[f"launch {label} (dry-run builder)"] = r["launches"][name]
        return out

    mla = moe_shapes[0]
    ssd_model, ssd_flat_row = ssd_rows["model"], ssd_rows["flat"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": sum(moe[a]["launches_per_generate"]["flash_attention"]
                        for a in MOE_MODELS),
        "launches_by_path": launches("flash_attention"),
        "max_abs_err": mla["max_abs_err"],
        "ms": mla["ms"], "plain_ms": mla["plain_ms"],
        "bound_ms": mla["bound_ms"], "bound_by": mla["bound_by"],
        "library_ms": mla["library_ms"],
        "per": "launch at deepseek-v2-lite-16b's MLA prefill shape (D = "
               "192); launches: the moe_serve generates (27 + 8 + 1)",
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(the same function at this shape; for the gemma2 "
                        "shapes without softcap: no torch call softcaps)",
        "shape": mla["shape"], "moe_shapes": moe_shapes,
        "whisper_shapes": whisper_shapes,
        "gemma2_shapes": shapes, "sweep_max_abs_err": sweep,
        "bf16_build": k1_build}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:28",
        "launches": moe["jamba-v0.1-52b"]["launches_per_generate"]["ssd"],
        "launches_by_path": launches("ssd"),
        "max_abs_err": ssd_jamba["max_abs_err"],
        "ms": ssd_jamba["ms"], "plain_ms": ssd_jamba["plain_ms"],
        "bound_ms": ssd_jamba["bound_ms"],
        "bound_by": ssd_jamba["bound_by"], "library_ms": None,
        "per": "wrapper call (one chained CUDA kernel in bf16, after a "
               "flag reset) at the shape jamba's prefill gives it (N = 16), "
               "once per Mamba layer; launches: the moe_serve jamba "
               "generate",
        "library_call": "none: no single PyTorch call computes the SSD scan",
        "shape": ssd_jamba["shape"], "mamba2_shape": ssd_model,
        "mamba2_flat_shape": ssd_flat_row,
        "short_chunks": ssd_short, "sweep_max_abs_err": ssd_worst,
        "bf16_build": k2_build}]
    print(json.dumps({"moe_serve": moe}))
    print(json.dumps({"whisper_serve": whisper}))
    print(json.dumps({"train": train}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"sim": sim}))
    print(json.dumps({"rt": rt}))
    print(json.dumps({"launch": launch}))
    print(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
