"""Serving launcher: batched prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 16 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --batch 4 --prompt-len 8192 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --param-dtype bfloat16 \
        --batch 4 --prompt-len 4096 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --batch 16 --prompt-len 64 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-4.0-h-small --reduced --device cpu

``--arch`` takes the reference's architectures and the port's own
(``configs.registry.list_port_archs``: granite-4.0-h-small, whose 40
layers are 64.4 GB in bfloat16; the benchmark serves 20 of them on one
card).

Attention layers run the flash-attention kernel and Mamba-2 layers the
SSD kernel (``attn_impl``/``ssd_impl`` "pallas", the reference's name);
on the CPU the kernels' wrappers take their plain versions. An
encoder-decoder arch (whisper) gets zero frame embeddings, (batch,
enc_seq, d_model), as in the reference: the audio frontend is a stub.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device, streams
from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"),
                    help="ModelConfig.param_dtype (default: the config's, "
                         "float32); deepseek-v2-lite-16b fits one 80 GB "
                         "card whole only in bfloat16")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = registry.reduce_for_smoke(cfg)
    cfg = cfg.replace(attn_impl="pallas", ssd_impl="pallas")
    if args.param_dtype:
        cfg = cfg.replace(param_dtype=args.param_dtype)
    params = api.init(streams.model_generator(args.seed, device), cfg)
    eng = ServeEngine(cfg, params, cap=args.prompt_len + args.steps,
                      device=device)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=device,
        generator=streams.sampler_generator(1, device))}
    if cfg.encdec:
        # the audio frontend is a stub: zero frame embeddings
        batch["frames"] = torch.zeros(
            (args.batch, cfg.enc_seq, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=device)
    t0 = time.perf_counter()
    out = eng.generate(batch, steps=args.steps,
                       temperature=args.temperature,
                       generator=streams.sampler_generator(2, device))
    out = out.cpu()
    dt = time.perf_counter() - t0
    print(f"{args.arch}: {out.shape[0]}x{out.shape[1]} tokens in {dt:.2f}s"
          f" ({out.numel()/dt:.1f} tok/s) on {device}")
    print("first row:", out[0].tolist())


if __name__ == "__main__":
    main()
