"""CPSL training launcher (the port of ``repro.launch.train``): for the
paper's LeNet, synthetic non-IID MNIST (the first half of
``examples/quickstart.py``); for an LM arch (``--arch``), a split LM on
synthetic Markov tokens (``MarkovLM``, ``LMClusterData``) priced by its
``lm_profile``. Then SAA cut selection (Alg. 2) and resource-managed CPSL
rounds (Algs. 1, 3, 4) with checkpoints and the wireless-latency
simulator.

    PYTHONPATH=src python -m repro_torch.launch.train --model lenet --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.train --model lenet \
        --rounds 2 --clusters 2 --cluster-size 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --rounds 2 --clusters 2 --cluster-size 2

Runs on ``cuda`` and raises without CUDA unless ``--device cpu`` is given;
convolutions and products run in full f32 (TF32 off). On ``cuda`` an LM
runs the hand-written kernels (``attn_impl``/``ssd_impl = "pallas"``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device, streams
from repro_torch.configs import registry
from repro_torch.configs.base import CPSLConfig
from repro_torch.core.channel import NetworkCfg
from repro_torch.core.cpsl import CPSL
from repro_torch.core.profile import lenet_profile, lm_profile
from repro_torch.core.resource import saa_cut_selection
from repro_torch.core.splitting import make_split_model
from repro_torch.data.pipeline import CPSLDataset, LMClusterData
from repro_torch.data.synthetic import MarkovLM, non_iid_split, synthetic_mnist
from repro_torch.models import api, lenet
from repro_torch.train.trainer import CPSLTrainer, TrainerCfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet", choices=["lenet"])
    ap.add_argument("--arch", default=None, help="LM arch id (see registry)")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale LM config (reduce_for_smoke)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=6)
    ap.add_argument("--cluster-size", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--cut", type=int, default=None)
    ap.add_argument("--saa", action="store_true",
                    help="select the cut layer with Alg. 2 (SAA)")
    ap.add_argument("--resource", default="gibbs",
                    choices=["gibbs", "random", "heuristic", "fixed"])
    ap.add_argument("--n-train", type=int, default=50_000)
    ap.add_argument("--n-test", type=int, default=10_000)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--log", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # f32 throughout, as in the reference: cuDNN would run f32
    # convolutions in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    n_devices = args.clusters * args.cluster_size
    ncfg = NetworkCfg(n_devices=n_devices)
    eval_fn = None
    if args.arch:
        cfg = registry.get(args.arch)
        if api.is_encdec(cfg):
            raise NotImplementedError(
                f"--arch {args.arch}: an encoder-decoder model needs frame "
                "embeddings, and the launcher's data (LMClusterData) "
                "yields only tokens and labels, as the reference's does; "
                "drive make_split_model and CPSL with {frames, tokens, "
                "labels} batches instead")
        if args.reduced:
            cfg = registry.reduce_for_smoke(cfg)
        if device.type == "cuda":
            cfg = cfg.replace(attn_impl="pallas", ssd_impl="pallas")
        prof = lm_profile(cfg, seq=args.seq)
        # the split needs a server layer: v < n_layers
        cuts = range(1, cfg.n_layers)
        ds = LMClusterData(MarkovLM(cfg.vocab_size, seed=args.seed),
                           n_devices, args.batch, args.seq, seed=args.seed)
        model_id = cfg
    else:
        xtr, ytr, xte, yte = synthetic_mnist(args.n_train, args.n_test,
                                             seed=args.seed)
        idx = non_iid_split(ytr, n_devices=n_devices, seed=args.seed)
        ds = CPSLDataset(xtr, ytr, idx, batch=args.batch)
        prof = lenet_profile()
        model_id, cuts = "lenet", None

        def eval_fn(cp, state):
            params, _ = cp.export_params(state)
            return lenet.accuracy(params, xte, yte)

    cut = args.cut
    if args.saa or cut is None:
        cut, means = saa_cut_selection(
            prof, ncfg, B=args.batch, L=args.local_epochs,
            n_clusters=args.clusters, cluster_size=args.cluster_size,
            n_samples=4, gibbs_iters=100, seed=args.seed, cuts=cuts)
        name = "" if args.arch else f" ({lenet.LAYERS[cut - 1]})"
        print(f"[SAA] optimal cut layer v* = {cut}{name} "
              f"(per-cut mean latency: {np.round(means, 2).tolist()})")

    ccfg = CPSLConfig(cut_layer=cut, n_clusters=args.clusters,
                      cluster_size=args.cluster_size,
                      local_epochs=args.local_epochs,
                      batch_per_device=args.batch)
    tcfg = TrainerCfg(rounds=args.rounds, ckpt_dir=args.ckpt_dir,
                      resource_mgmt=args.resource, log_path=args.log,
                      seed=args.seed)

    trainer = CPSLTrainer(CPSL(make_split_model(model_id, cut), ccfg), ds,
                          prof, ncfg, tcfg, eval_fn=eval_fn, device=device)
    trainer.run(streams.model_generator(args.seed, device), v=cut)
    for h in trainer.history:
        print(json.dumps(h))
    return trainer.history


if __name__ == "__main__":
    main()
