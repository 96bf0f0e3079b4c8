"""Fault-tolerant CPSL training loop and experiment fleets (the port of
``repro.train.trainer``: ``CPSLTrainer`` and ``FleetRunner``).

Each round (paper Alg. 1):
  1. draw the network state (device compute + channels),
  2. small-timescale resource management: Gibbs clustering + greedy
     spectrum (Algs. 3/4), multi-chain best-of-R Gibbs ("gibbs-mc", the
     lockstep planner of ``sim.batched``), or heuristic / random / fixed
     clustering — the reference's NumPy planner, copied, so its decisions
     are identical,
  3. run intra-cluster epochs + FedAvg per cluster on the device — the
     looped path (one step per epoch, batches gathered on the host) or,
     with ``CPSLConfig.fused_round``, ``CPSL.run_round_fused`` over a
     device-resident dataset (metrics sync every ``log_every`` rounds),
  4. accumulate the simulated wireless latency of the round (eqs. 15-25)
     next to the measured wall-clock (``wall_s``, of which ``plan_s`` is
     the host planner's share),
  5. checkpoint every ``ckpt_every`` rounds (async, atomic, keep-k);
     auto-resume picks up the latest checkpoint including rounds.

Failure handling: ``fail_at_round`` injects a crash (tests restart the
trainer and check a bit-exact continuation); SIGTERM triggers a final
checkpoint before exit.

``FleetRunner`` runs a ``FleetConfig`` grid (cluster sizes x lr scales x
seeds) as one ``CPSL.run_fleet`` call over a shared device-resident
dataset and extracts per-replica curves.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, streams, tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import CPSLConfig, FleetConfig
from repro_torch.core import latency as lt
from repro_torch.core import resource as rs
from repro_torch.core.channel import NetworkCfg, device_means, sample_network
from repro_torch.core.compression import compression_ratio
from repro_torch.core.cpsl import CPSL, to_device
from repro_torch.core.latency import CutProfile
from repro_torch.core.splitting import make_split_model
from repro_torch.data.pipeline import (DeviceResidentDataset, batch_seed,
                                       fleet_plan)
from repro_torch.data.synthetic import non_iid_split
from repro_torch.lifecycle import GracefulStop
from repro_torch.sim.batched import gibbs_clustering_multichain


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainerCfg:
    rounds: int = 10
    ckpt_every: int = 5
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    async_ckpt: bool = True
    resource_mgmt: str = "gibbs"      # gibbs | gibbs-mc | random | heuristic | fixed
    gibbs_iters: int = 200
    gibbs_chains: int = 4             # lockstep replicas for "gibbs-mc"
                                      # (best-of-R; chain 0 == "gibbs")
    fail_at_round: Optional[int] = None
    log_path: Optional[str] = None
    log_every: int = 1                # fused rounds keep metrics on device;
                                      # host-sync + JSONL flush every this
                                      # many rounds (1 == every round)
    seed: int = 0


class CPSLTrainer:
    """Runs CPSL rounds on ``device`` (``cuda`` unless the caller asks for
    ``cpu``; no CUDA raises), the planner and the latency model on the
    host."""

    def __init__(self, cpsl: CPSL, dataset, prof: CutProfile,
                 ncfg: NetworkCfg, tcfg: TrainerCfg,
                 eval_fn: Optional[Callable] = None, device="cuda"):
        self.cpsl, self.ds, self.prof = cpsl, dataset, prof
        self.ncfg, self.tcfg = ncfg, tcfg
        self.eval_fn = eval_fn
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep,
                                 async_save=tcfg.async_ckpt)
        self.mu_f, self.mu_snr = device_means(ncfg, tcfg.seed)
        # upload compression shrinks xi_d on the DMT uplink; the shrunk
        # profile is cut-independent, so build it once
        cr = compression_ratio(cpsl.ccfg.compress_uploads,
                               cpsl.ccfg.compress_topk)
        if cr < 1.0:
            prof2 = copy.copy(prof)
            prof2.xi_d = prof.xi_d * cr
            self._prof_compressed: Optional[CutProfile] = prof2
        else:
            self._prof_compressed = None
        # fused-round path: the dataset lives on the device once; each
        # round ships only an (M, L, K, B) index table
        self._ds_dev: Optional[DeviceResidentDataset] = (
            DeviceResidentDataset.coerce(dataset, self.device)
            if cpsl.ccfg.fused_round else None)
        self.history: List[dict] = []
        self._pending: List[dict] = []
        # SIGTERM => finish the round, checkpoint (blocking), exit clean
        self.stop = GracefulStop().install()

    @property
    def _stop(self) -> bool:
        return self.stop.triggered

    # -- round-level resource management (paper small timescale) -------------

    def _plan_round(self, v: int, rnd: int):
        rng = streams.trainer_round_rng(self.tcfg.seed, rnd)
        net = sample_network(self.ncfg, self.mu_f, self.mu_snr, rng)
        ccfg = self.cpsl.ccfg
        M, K = ccfg.n_clusters, ccfg.cluster_size
        B, L = ccfg.batch_per_device, ccfg.local_epochs
        kind = self.tcfg.resource_mgmt
        if kind == "gibbs":
            clusters, xs, lat = rs.gibbs_clustering(
                v, net, self.ncfg, self.prof, B, L, M, K,
                iters=self.tcfg.gibbs_iters, seed=self.tcfg.seed + rnd)
        elif kind == "gibbs-mc":
            # best-of-R lockstep chains (chain 0 == the "gibbs" stream, so
            # this never plans worse than "gibbs" at the same seed)
            clusters, xs, lat = gibbs_clustering_multichain(
                v, net, self.ncfg, self.prof, B, L, M, K,
                iters=self.tcfg.gibbs_iters, seed=self.tcfg.seed + rnd,
                chains=max(1, self.tcfg.gibbs_chains))
        elif kind == "heuristic":
            clusters, xs, lat = rs.heuristic_clustering(
                v, net, self.ncfg, self.prof, B, L, M, K)
        elif kind in ("random", "fixed"):
            clusters, xs, lat = rs.random_clustering(
                v, net, self.ncfg, self.prof, B, L, M, K,
                seed=(0 if kind == "fixed" else self.tcfg.seed + rnd))
        else:
            raise ValueError(f"resource_mgmt={kind!r}")
        if self._prof_compressed is not None:
            lat = lt.round_latency(v, clusters, xs, net, self.ncfg,
                                   self._prof_compressed, B, L)
        return clusters, xs, lat

    def _keep(self, rnd: int, n_clusters: int):
        if self.cpsl.ccfg.straggler_dropout > 0:
            return self.cpsl.keep_table(self.tcfg.seed, rnd, n_clusters)
        return None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main loop ------------------------------------------------------------

    def run(self, generator: Optional[torch.Generator] = None,
            v: Optional[int] = None, state: Optional[dict] = None):
        """Train ``tcfg.rounds`` rounds from ``state`` (default: a fresh
        ``init_state(generator)``), or from the latest checkpoint in
        ``ckpt_dir`` when there is one. Returns the final state."""
        v = v if v is not None else self.cpsl.ccfg.cut_layer
        if state is None:
            state = self.cpsl.init_state(generator)
        state = tree.map(lambda t: t.to(self.device), state)
        start_round, sim_time = 0, 0.0
        meta_target = {
            "round": torch.zeros((), dtype=torch.int32, device=self.device),
            "sim_time": torch.zeros((), device=self.device), "state": state}
        restored = self.ckpt.restore(meta_target)
        if restored is not None:
            state = restored["state"]
            start_round = int(restored["round"])
            sim_time = float(restored["sim_time"])

        try:
            for rnd in range(start_round, self.tcfg.rounds):
                if self.tcfg.fail_at_round is not None \
                        and rnd == self.tcfg.fail_at_round:
                    raise SimulatedFailure(f"injected failure at round {rnd}")
                t0 = time.monotonic()
                clusters, xs, lat = self._plan_round(v, rnd)
                plan = time.monotonic() - t0
                keep = self._keep(rnd, len(clusters))

                if self._ds_dev is not None:
                    # fused round: batches gathered on the device from the
                    # index table; the loss stays a device scalar until
                    # the next log flush
                    idx = self._ds_dev.round_index_table(
                        clusters, self.tcfg.seed, rnd,
                        self.cpsl.ccfg.local_epochs)
                    state, metrics = self.cpsl.run_round_fused(
                        state, self._ds_dev.data, idx,
                        self._ds_dev.cluster_weights(clusters), keep)
                    # wait for the device so wall_s is a real measurement
                    self._sync()
                else:
                    def batch_fn(m, l, _clusters=clusters, _rnd=rnd):
                        b = self.ds.cluster_batch(
                            _clusters[m],
                            seed=batch_seed(self.tcfg.seed, _rnd, m, l))
                        return {k: to_device(a, self.device)
                                for k, a in b.items()}

                    sizes = (np.stack([self.ds.data_sizes(c)
                                       for c in clusters])
                             if hasattr(self.ds, "data_sizes") else None)
                    state, metrics = self.cpsl.run_round(
                        state, batch_fn, n_clusters=len(clusters),
                        data_sizes=sizes, keep=keep)
                sim_time += lat
                wall = time.monotonic() - t0
                rec = {"round": rnd, "loss": metrics["loss"],
                       "sim_latency_s": lat, "sim_time_s": sim_time,
                       "wall_s": wall, "plan_s": plan}
                if self.eval_fn is not None:
                    rec["eval"] = self.eval_fn(self.cpsl, state)
                self.history.append(rec)
                self._pending.append(rec)

                last = rnd == self.tcfg.rounds - 1
                if (rnd + 1) % self.tcfg.log_every == 0 or last \
                        or self._stop:
                    self._flush_logs()
                if (rnd + 1) % self.tcfg.ckpt_every == 0 or last \
                        or self._stop:
                    self.ckpt.save(
                        {"round": torch.tensor(rnd + 1, dtype=torch.int32),
                         "sim_time": torch.tensor(sim_time,
                                                  dtype=torch.float32),
                         "state": state},
                        step=rnd + 1, block=last or self._stop)
                if self._stop:
                    break
        finally:
            self._flush_logs()
        self.ckpt.wait()
        return state

    def _flush_logs(self):
        """Host-sync pending round metrics and append them to the JSONL
        log — the fused path's single sync point (every ``log_every``
        rounds)."""
        pending, self._pending = self._pending, []
        for rec in pending:
            rec["loss"] = float(rec["loss"])
            if self.tcfg.log_path:
                with open(self.tcfg.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")


# --------------------------------------------------------------------------
# Experiment fleets: the sweep grid as one batched program
# --------------------------------------------------------------------------

class FleetRunner:
    """Multi-seed / multi-config CPSL experiment fleet: the full
    ``FleetConfig`` grid (cluster sizes x lr scales x seeds) runs as ONE
    batched program (``CPSL.run_fleet``) over a shared device-resident
    dataset, with per-replica non-IID shard tables, padded cluster
    layouts, and eval on the device.

    Fixed round-robin clustering (the fig. 5/6 setting) — per-round Gibbs
    planning is host-interactive and stays on ``CPSLTrainer``. Wireless
    latency is priced per replica on the host from the same equal-spectrum
    model the fig benchmarks use (``core.latency.equal_split_curve``).

    Runs on ``device`` (``cuda`` unless the caller asks for ``cpu``; no
    CUDA raises). Every table is uploaded before the curve starts, and the
    losses and evals stay on the device until ``run`` reads them once."""

    def __init__(self, xtr, ytr, fcfg: FleetConfig, ccfg: CPSLConfig,
                 xte=None, yte=None, model: str = "lenet",
                 prof: Optional[CutProfile] = None,
                 ncfg: Optional[NetworkCfg] = None, batch=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.fcfg, self.base_ccfg = fcfg, ccfg
        self.prof, self.ncfg = prof, ncfg
        B = batch or ccfg.batch_per_device
        lr_scales = fcfg.lr_scales or (1.0,)

        # the replica grid, row-major: cluster_size x lr_scale x seed
        self.specs: List[dict] = []
        for nm in fcfg.cluster_sizes:
            assert fcfg.n_devices % nm == 0, (fcfg.n_devices, nm)
            M = fcfg.n_devices // nm
            layout = [list(range(m * nm, (m + 1) * nm)) for m in range(M)]
            for ls in lr_scales:
                for seed in fcfg.seeds:
                    self.specs.append({"seed": int(seed),
                                       "cluster_size": int(nm),
                                       "n_clusters": M,
                                       "lr_scale": float(ls),
                                       "layout": layout})

        self.shards = {s: non_iid_split(
            ytr, n_devices=fcfg.n_devices,
            samples_per_device=fcfg.samples_per_device, seed=s)
            for s in {sp["seed"] for sp in self.specs}}
        self.plan = fleet_plan(
            [self.shards[sp["seed"]] for sp in self.specs], B,
            [sp["layout"] for sp in self.specs],
            [sp["seed"] for sp in self.specs],
            fcfg.rounds, ccfg.local_epochs)

        # one CPSL at the PADDED shape: the grid's variants differ only
        # in data (tables, masks, weights, lr scales)
        M_pad, K_pad = self.plan.idx.shape[2], self.plan.idx.shape[4]
        self.ccfg = dataclasses.replace(ccfg, n_clusters=M_pad,
                                        cluster_size=K_pad)
        self.cpsl = CPSL(make_split_model(model, self.ccfg.cut_layer,
                                          conv_impl=self.ccfg.conv_impl),
                         self.ccfg)
        self.dsd = DeviceResidentDataset(
            xtr, ytr, self.shards[self.specs[0]["seed"]], B,
            eval_images=xte, eval_labels=yte, device=self.device)
        self.lr_scale = (np.array([sp["lr_scale"] for sp in self.specs],
                                  np.float32)
                         if fcfg.lr_scales else None)
        self.keep = (self._keep_tables()
                     if ccfg.straggler_dropout > 0 else None)

    def _keep_tables(self) -> np.ndarray:
        """(E, R, M, K) straggler keep tables: replica e's drawn at its
        own unpadded layout from the ``straggler`` stream with its seed
        (what its solo run draws), padded slots False."""
        E, R, M, _, K, _ = self.plan.idx.shape
        keep = np.zeros((E, R, M, K), bool)
        for e, sp in enumerate(self.specs):
            for r in range(R):
                keep[e, r, :sp["n_clusters"], :sp["cluster_size"]] = \
                    self.cpsl.keep_table(sp["seed"], r, sp["n_clusters"],
                                         sp["cluster_size"])
        return keep

    def upload(self) -> dict:
        """The plan's tables on the fleet's device (one non-blocking copy
        each), ready for ``CPSL.run_fleet``."""
        dev = self.device
        return {
            "idx": to_device(self.plan.idx, dev),
            "weights": to_device(self.plan.weights, dev, torch.float32),
            "lr_scale": to_device(self.lr_scale, dev, torch.float32),
            "cluster_mask": to_device(self.plan.cluster_mask, dev,
                                      torch.bool),
            "client_mask": to_device(self.plan.client_mask, dev, torch.bool),
            "keep": to_device(self.keep, dev, torch.bool)}

    def _price_latency(self, spec) -> List[float]:
        """Cumulative per-round wireless latency for one replica — the
        shared equal-spectrum loop (``core.latency.equal_split_curve``),
        priced at the replica's actual cut layer."""
        if self.prof is None or self.ncfg is None:
            return []
        return lt.equal_split_curve(
            self.base_ccfg.cut_layer, spec["layout"], self.ncfg,
            self.prof, self.base_ccfg.batch_per_device,
            self.base_ccfg.local_epochs, self.fcfg.rounds, spec["seed"])

    def run(self, states: Optional[dict] = None) -> dict:
        """Run the fleet (one batched program) and extract per-replica
        curves. ``states``: the initial fleet state (default
        ``init_fleet_state`` of the plan's seeds). Returns ``{"replicas":
        [...], "wall_s", "n_replicas", "eval_rounds"}``; each replica dict
        carries its grid coordinates plus ``loss`` (R,), ``acc`` /
        ``eval_loss`` at the eval rounds, and cumulative ``sim_time_s``.
        ``wall_s`` runs from the initial state to the curves on the
        host."""
        fcfg = self.fcfg
        t0 = time.monotonic()
        if states is None:
            states = self.cpsl.init_fleet_state(self.plan.seeds, self.device)
        else:
            states = tree.map(lambda t: t.to(self.device), states)
        tb = self.upload()
        eval_data = self.dsd.eval_data if fcfg.eval_every else None
        states, metrics = self.cpsl.run_fleet(
            states, self.dsd.data, tb["idx"], tb["weights"],
            lr_scale=tb["lr_scale"], eval_data=eval_data,
            eval_every=fcfg.eval_every, cluster_mask=tb["cluster_mask"],
            client_mask=tb["client_mask"], keep=tb["keep"])
        loss = metrics["loss"].cpu().numpy()
        evals = metrics.get("eval")
        if evals is not None:
            evals = {k: v.cpu().numpy() for k, v in evals.items()}
        wall = time.monotonic() - t0

        replicas = []
        for e, spec in enumerate(self.specs):
            rep = {k: spec[k] for k in ("seed", "cluster_size",
                                        "n_clusters", "lr_scale")}
            rep["loss"] = [float(x) for x in loss[e]]
            if evals is not None:
                rep["acc"] = [float(x) for x in evals["acc"][e]]
                rep["eval_loss"] = [float(x) for x in evals["loss"][e]]
            lat = self._price_latency(spec)
            if lat:
                rep["sim_time_s"] = lat
            replicas.append(rep)
        out = {"replicas": replicas, "wall_s": wall,
               "n_replicas": len(replicas)}
        if evals is not None:
            out["eval_rounds"] = metrics["eval_rounds"]
        self.states = states
        return out
