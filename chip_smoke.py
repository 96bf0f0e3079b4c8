#!/usr/bin/env python3
"""The port's hand-written kernels timed on the card (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits nonzero without a card. It prints
the card's name and power limit, builds every kernel from
``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and prints
each entry's registers, shared memory and spills from the ptxas log. Then
it times each kernel in bf16 with CUDA events at the shapes the main paths
give it, one row a shape:

- K1 (flash attention) at D = 256 (gemma2-2b's global layer: batch 4, 5120
  tokens, softcap 50), 192 (deepseek-v2-lite's MLA: batch 4, 4096 tokens,
  v padded from 128), 128 (phi3.5-moe's and jamba's GQA, 32 query heads
  over 8) and 64 (whisper-small's encoder over 1500 frames and its
  cross-attention from a 64-token prompt, 16 clips);
- K2 (the SSD scan) at mamba2-2.7b's prefill (batch 4, 8192 tokens) and
  jamba's N = 16 (batch 4, 4096), in the model layout;
- K2's backward at the CPSL train cell's server and device batches (4 and
  2 sequences of 4096);
- the Mamba-2 mixer's gated output stage, forward and backward, at the
  train cell's server rows, mamba2's serve prefill and its decode step;
- the Mamba-2 mixer's causal conv and SiLU, forward and backward, at the
  train cell's server rows and mamba2's serve prefill, xBC read from
  in_proj's rows.

A row gives the kernel's ms, the ms of its plain PyTorch version (the
recompute the backward replaced, and the eager chains the gated and the
conv stages replaced), a PyTorch library call's ms where one computes the
same function (``scaled_dot_product_attention``, for K1 without a softcap),
and the least time the card could take, with the kernel's share of it. The
least time is the benchmark's own arithmetic, ``perfbench/harness/work.py``
and the ``k2_bwd_roofline_pct.train`` metric's ``bwd_work``, on the
operands and results the wrapper reports through ``kernels.record_call``
to the benchmark's observer. Before it is timed, each kernel's result at
that shape is held to its plain version under the card suite's limits and
comparisons (``tests/test_torch_cuda.py``); the row gives the error.

Then each main path runs once at full width with every kernel's launches
counted from zero: a ``ServeEngine.generate`` of gemma2-2b (4 x 5120
tokens, 16 greedy steps) and of mamba2-2.7b (its serve cell's 4 x 8192, 32
steps), and one CPSL cluster step of mamba2-2.7b at its train cell's size
(2 devices x 2 sequences of 4096, cut 1, remat). The counts must be the
card suite's (``tests/test_torch_cuda_models.py``: ``_expected_launches``,
``_lm_step_launches``). The suite holds every other check
(``pytest -m requires_cuda tests/test_torch_cuda*.py``).

Prints one JSON line a row, a ``{"kernels": [...], "launches": {...}}``
line, the script's seconds and, last, the device line
``{"ok": true, "device": {...}}``; an AssertionError where a kernel's
result or a main path's launches are not what the suite holds them to.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from perfbench.harness import work  # noqa: E402
from perfbench.harness.bench import Record, load_module  # noqa: E402


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


def device_phase() -> str:
    """The card's name and power limit; every kernel built, with each
    entry's registers, shared memory and spills."""
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    seconds = _build.build()
    log(f"kernels built in {seconds:.1f} s: {', '.join(_build.sources())}")
    for name in _build.sources():
        fn, spill = None, ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line and fn:
                log(f"  {name}: {fn}: {line.split(':', 1)[1].strip()}; "
                    f"{spill}")
                fn = None
    return smi


def _row(label: str, name: str, call, plain, library, work_fn, reps: int,
         check) -> dict:
    """``call`` (one kernel call through its wrapper) timed over ``reps``
    launches after a warm-up, beside ``plain`` and ``library`` (None where
    no PyTorch call computes the same function). The least time is
    ``work_fn(operands, results)`` on the (shape, itemsize) pairs that the
    wrapper reported as ``name`` in one call, through ``work.bound_s``.
    That call's result goes to ``check``, which asserts it within the
    suite's limit and returns its errors."""
    import torch
    from repro_torch import kernels
    rec = Record({}, {})
    kernels.observers.append(rec)
    try:
        out = call()
    finally:
        kernels.observers.remove(rec)
    torch.cuda.synchronize()
    err = check(out)
    (_, _, ops, res), = rec.calls_of("", name)
    flops, nbytes = work_fn(ops, res)
    bound_ms = 1e3 * work.bound_s(flops, nbytes)
    ms = time_ms(call, reps)
    row = {"row": label, "call": name,
           "operands": [list(shape) for shape, _ in ops], "err": err,
           "ms": ms, "plain_ms": time_ms(plain, 2),
           "library_ms": None if library is None else time_ms(library, reps),
           "bound_ms": bound_ms,
           "bound_by": ("bytes" if work.bound_s(0, nbytes)
                        >= work.bound_s(flops, 0) else "flops"),
           "share_pct": 100 * bound_ms / ms}
    log(json.dumps(row))
    return row


# K1: (label, batch, kv heads a row, query heads a kv head, Sq, Skv, D,
# causal, softcap, v's own width where the caller pads v to D)
FLASH_ROWS = [
    ("K1 D=256 gemma2-2b global", 4, 4, 2, 5120, 5120, 256, True, 50.0,
     None),
    ("K1 D=192 deepseek-v2-lite MLA", 4, 16, 1, 4096, 4096, 192, True, 0.0,
     128),
    ("K1 D=128 phi3.5-moe / jamba GQA", 4, 8, 4, 4096, 4096, 128, True, 0.0,
     None),
    ("K1 D=64 whisper-small encoder", 16, 12, 1, 1500, 1500, 64, False, 0.0,
     None),
    ("K1 D=64 whisper-small cross", 16, 12, 1, 64, 1500, 64, False, 0.0,
     None),
]


def flash_rows() -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from test_torch_cuda import _flash_err, _randn
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, B, G, R, Sq, Skv, D, causal, cap, dv in FLASH_ROWS:
        q = _randn(gen, B * G * R, Sq, D, dtype=torch.bfloat16)
        k, v = (_randn(gen, B * G, Skv, D, dtype=torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, window=0, softcap=cap, q_offset=0,
                  kv_repeat=R)
        q4 = q.view(B, G * R, Sq, D)
        k4, v4 = k.view(B, G, Skv, D), v.view(B, G, Skv, D)
        library = None if cap else (
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=R > 1))

        def check(got, q=q, k=k, v=v, kw=kw, cap=cap):
            err, tol = _flash_err(got, attention_ref(q, k, v, **kw), cap)
            assert err <= tol, (err, tol)
            return err

        rows.append(_row(
            label, "flash_attention",
            lambda: flash_attention_flat(q, k, v, **kw),
            lambda: attention_ref(q, k, v, **kw), library,
            lambda ops, res: work.flash_attention_work(
                ops, res, causal=causal, dv=dv),
            20 if Sq * Skv < 1 << 24 else 10, check))
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return rows


# K2: (label, batch, tokens, heads, P, N); chunk 256
SSD_ROWS = [("K2 mamba2-2.7b prefill", 4, 8192, 80, 64, 128),
            ("K2 jamba N=16 prefill", 4, 4096, 128, 64, 16)]
# K2's backward: (label, batch, tokens, heads, P, N); chunk 256
SSD_BWD_ROWS = [("K2 bwd train server", 4, 4096, 80, 64, 128),
                ("K2 bwd train device", 2, 4096, 80, 64, 128)]


def ssd_rows() -> list:
    """K2 through ``ops.ssd`` beside ``ssd_grouped_ref``, at the suite's
    model layout; its backward kernel beside the plain recompute it
    replaced (``ssd_chunked``'s gradient in bf16, B and C broadcast to the
    heads), held to that gradient in f32."""
    import torch
    from repro_torch.kernels.ssd import bwd
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.kernel import chunk_len
    from repro_torch.kernels.ssd.ref import ssd_grouped_ref
    from repro_torch.models import mamba2 as mb
    from test_torch_cuda import (SSD_BF16_TOL, _packed_model_layout,
                                 _rel_errs, _ssd_bwd_inputs, _ssd_err,
                                 _ssd_plain_grads, _within)
    bwd_work = load_module("metrics", "k2_bwd_roofline_pct.train").bwd_work
    gen = torch.Generator(device="cuda").manual_seed(3)
    chunk, rows = 256, []
    for label, B_, S, H, P, N in SSD_ROWS:
        args = _packed_model_layout(gen, B_, S, H, 1, P, N, torch.bfloat16,
                                    0.125)

        def check(got, args=args, S=S):
            err = _ssd_err(got, ssd_grouped_ref(*args,
                                                chunk=chunk_len(S, chunk)))
            assert err < SSD_BF16_TOL, err
            return err

        rows.append(_row(
            label, "ssd", lambda: ssd_ops.ssd(*args, chunk=chunk),
            lambda: ssd_grouped_ref(*args, chunk=chunk_len(S, chunk)), None,
            lambda ops, res: work.ssd_work(ops, res, chunk), 10, check))
        del args
        torch.cuda.empty_cache()
    for label, B_, S, H, P, N in SSD_BWD_ROWS:
        *ins, gy, _ = _ssd_bwd_inputs(gen, B_, S, H, 1, P, N)

        def plain(ins=ins, gy=gy, H=H):
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            y, _ = mb.ssd_chunked(leaves[0], leaves[1], leaves[2],
                                  mb._broadcast_groups(leaves[3], H),
                                  mb._broadcast_groups(leaves[4], H),
                                  chunk=chunk)
            return torch.autograd.grad(y, leaves, gy)

        def check(got, ins=ins, gy=gy):
            errs = _rel_errs(got, _ssd_plain_grads(*ins, gy, None, chunk))
            assert _within(errs), errs
            return errs

        rows.append(_row(
            label, "ssd_bwd", lambda: bwd.ssd_bwd(*ins, gy, None, chunk=chunk),
            plain, None, lambda ops, res: bwd_work(ops, res, chunk), 10,
            check))
        del ins, gy
        torch.cuda.empty_cache()
    return rows


# the gated stage: (label, rows, W, H): a CPSL train cell's server step (4
# x 4096 tokens), mamba2-2.7b's serve prefill (4 x 8192) and decode step
GATED_ROWS = [("train", 16384, 5120, 80), ("prefill", 32768, 5120, 80),
              ("decode", 4, 5120, 80)]


def gated_rows() -> list:
    """The stage's forward and backward kernels (``kernels/gated_norm``),
    x and z column slices of wider rows as the mixer passes them, beside
    the eager chain (``gated_norm_ref`` and its autograd backward), held to
    the f64 gradient of the plain version. Its few dozen flops an element
    leave it bound by bytes: every operand and result once, as
    ``work._nbytes`` counts them."""
    import torch
    from repro_torch.kernels.gated_norm import kernel as gk
    from repro_torch.kernels.gated_norm.ref import gated_norm_ref
    from test_torch_cuda import (GATED_TOL, _gated_errs, _gated_f64,
                                 _gated_inputs)
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf, eps, rows = torch.bfloat16, 1e-5, []

    def nbytes(ops, res):
        return 0, work._nbytes(list(ops) + list(res))

    for label, R, W, H in GATED_ROWS:
        y, x, z, D, scale, dout = _gated_inputs(gen, R, W, H, bf)
        rstd = gk.gated_norm_fwd(y, x, z, D, scale, eps)[1]
        want = _gated_f64(y, x, z, D, scale, dout)
        leaves = [t.detach().requires_grad_() for t in (y, x, z, D, scale)]
        ref = gated_norm_ref(*leaves, eps)
        reps = 20 if R > 64 else 200

        def check(out=None, grads=None, want=want):
            errs = _gated_errs(out, grads, want)
            assert all(e <= GATED_TOL[bf] for e in errs.values()), errs
            return errs

        rows.append(_row(
            f"GN fwd {label}", "gated_norm",
            lambda: gk.gated_norm_fwd(y, x, z, D, scale, eps),
            lambda: gated_norm_ref(y, x, z, D, scale, eps), None, nbytes,
            reps, lambda got: check(out=got[0])))
        rows.append(_row(
            f"GN bwd {label}", "gated_norm_bwd",
            lambda: gk.gated_norm_bwd(y, x, z, D, scale, rstd, dout),
            lambda: torch.autograd.grad(ref, leaves, dout,
                                        retain_graph=True), None, nbytes,
            reps, lambda got: check(grads=got)))
        del y, x, z, D, scale, dout, rstd, leaves, ref, want
        torch.cuda.empty_cache()
    return rows


# the conv stage: (label, batch, tokens) at mamba2-2.7b's widths (xBC the
# 5,376 columns from 5,120 of in_proj's 10,576): a CPSL train cell's server
# step (4 x 4096 tokens) and its serve prefill (4 x 8192)
CONV_ROWS = [("train", 4, 4096), ("prefill", 4, 8192)]


def conv_rows() -> list:
    """The stage's forward and backward kernels (``kernels/causal_conv``),
    xBC a column slice of in_proj's rows as the mixer passes it, beside the
    eager chain they replaced (the cat that rebuilt xBC from its three
    slices, ``causal_conv_silu_ref`` and its autograd backward), held to
    the f64 gradient of the plain version. A few flops an element leave it
    bound by bytes: every operand and result once, as ``work._nbytes``
    counts them."""
    import torch
    from repro_torch.kernels.causal_conv import kernel as ck
    from repro_torch.kernels.causal_conv.ref import causal_conv_silu_ref
    from test_torch_cuda import (CONV_TOL, _conv_errs, _conv_f64,
                                 _conv_inputs, _conv_sums_within)
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf, rows = torch.bfloat16, []

    def nbytes(ops, res):
        return 0, work._nbytes(list(ops) + list(res))

    def eager(x, w, b):
        xbc = torch.cat(x.split([5120, 128, 128], dim=-1), dim=-1)
        return causal_conv_silu_ref(xbc, w, b)

    for label, B_, S in CONV_ROWS:
        x, w, b, dy = _conv_inputs(gen, B_, S, 5376, 10576, 5120, 4, bf)
        want, mags = _conv_f64(x, w, b, dy)
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        ref = eager(*leaves)

        def check(out=None, grads=None, want=want, mags=mags):
            errs = _conv_errs(out, grads, want)
            assert all(e <= CONV_TOL[bf] for e in errs.values()), errs
            assert grads is None or _conv_sums_within(grads, want, mags)
            return errs

        rows.append(_row(
            f"CC fwd {label}", "causal_conv",
            lambda: ck.causal_conv_fwd(x, w, b), lambda: eager(x, w, b),
            None, nbytes, 20, lambda got: check(out=got)))
        rows.append(_row(
            f"CC bwd {label}", "causal_conv_bwd",
            lambda: ck.causal_conv_bwd(x, w, b, dy),
            lambda: torch.autograd.grad(ref, leaves, dy, retain_graph=True),
            None, nbytes, 20, lambda got: check(grads=got)))
        del x, w, b, dy, want, mags, leaves, ref
        torch.cuda.empty_cache()
    return rows


# the main paths: (arch, greedy steps) of a generate at the card suite's
# batch and prompt (its SERVE_MODELS); mamba2's 32 steps are its serve
# cell's, gemma2 has no cell
SERVE_RUNS = [("gemma2-2b", 16), ("mamba2-2.7b", 32)]
# the mamba2-2.7b train cell's cluster step: sequence, sequences a device
TRAIN_SEQ, TRAIN_BATCH = 4096, 2


def _launches_of(counter, run, want: dict, label: str) -> dict:
    """``counter`` from zero around ``run()``, which must have launched
    each kernel ``want`` times."""
    import torch
    counter.reset()
    run()
    torch.cuda.synchronize()
    got = dict(counter)
    assert got == want, f"{label}: launches {got}, the suite's rule {want}"
    log(f"launches {label}: {json.dumps(got)}")
    return got


def main_path_launches() -> dict:
    """Each main path once at full width, the kernels' launches counted
    around it and held to the card suite's rules."""
    import torch
    from repro_torch import streams, telemetry
    from repro_torch.configs import registry
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.splitting import make_split_model
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine
    from test_torch_cuda_models import (LM_K, LM_LOSS_CHUNK, LM_M,
                                        _expected_launches, _lm_batches,
                                        _lm_step_launches, _serve_batch,
                                        _serve_cfgs)
    out = {}
    with telemetry.LaunchCounter() as counter:
        for arch, steps in SERVE_RUNS:
            cfg, _, batch_size, prompt = _serve_cfgs(arch)
            params = api.init(streams.model_generator(0, "cuda"), cfg)
            eng = ServeEngine(cfg, params, cap=prompt + steps, device="cuda")
            batch = _serve_batch(cfg, batch_size, prompt, "cuda")
            out[f"{arch} generate"] = _launches_of(
                counter, lambda: eng.generate(batch, steps=steps),
                _expected_launches(cfg, steps),
                f"{arch} generate {batch_size} x {prompt}, {steps} steps")
            del params, eng, batch
            torch.cuda.empty_cache()
        cfg = registry.get("mamba2-2.7b").replace(
            dtype="bfloat16", param_dtype="float32", remat=True,
            loss_chunk=LM_LOSS_CHUNK, ssd_impl="pallas")
        cp = CPSL(make_split_model(cfg, 1), CPSLConfig(
            cut_layer=1, n_clusters=LM_M, cluster_size=LM_K, local_epochs=1,
            batch_per_device=TRAIN_BATCH))
        state = cp.init_state(streams.model_generator(0, "cuda"))
        batch = _lm_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, "cuda")[0, 0]
        out["mamba2-2.7b cpsl step"] = _launches_of(
            counter, lambda: cp.cluster_step(state, batch),
            _lm_step_launches(cfg, "ssd", 1),
            f"mamba2-2.7b cluster step {LM_K} x {TRAIN_BATCH} x {TRAIN_SEQ}")
        del cp, state, batch
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = device_phase()
    rows = flash_rows() + ssd_rows() + gated_rows() + conv_rows()
    launches = main_path_launches()
    print(json.dumps({"kernels": rows, "launches": launches, "card": smi}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
