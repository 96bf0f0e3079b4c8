"""Event-driven round executor: "train CPSL under network dynamics" (the
port of ``repro.sim.engine``).

Couples four pieces:

  * ``sim.dynamics.NetworkProcess``  — Gauss-Markov fading + churn + energy
  * ``sim.controller``               — online two-timescale Algs. 2-4
  * ``core.latency``                 — the eq. (15)-(25) wireless cost model
  * ``core.cpsl.CPSL``               — the PyTorch split-learning trainer

Each round (== one small-timescale slot):
  1. snapshot the network; on epoch boundaries re-select the cut layer
     (large timescale) — a cut change re-splits the model and restarts the
     device/server parameters from the run's ``torch.Generator`` (the
     reference splits its PRNG key there instead; torch cannot reproduce
     those draws, so parity tests pass the reference's first state in);
  2. plan the slot (Gibbs clustering + vectorized greedy spectrum);
  3. devices may vanish mid-round -> ``controller.repair`` (stale plan);
  4. score the executed plan with the latency model and advance sim time;
  5. run the CPSL training round on the planned clusters — looped, or
     ``CPSL.run_round_fused`` over a device-resident dataset when
     ``CPSLConfig.fused_round`` is set;
  6. drain device batteries (compute + transmit energy), possibly
     triggering depletion departures;
  7. evolve the fading/compute processes and sample arrivals;
  8. append a JSONL trace record with everything needed to *recompute*
     the round latency offline (f, rate, clusters, xs, v).

The controller, the network process and the latency model are the
reference's NumPy code, copied, so the decisions and latencies are the
reference's, bit for bit; the training runs on ``device`` (``cuda``
unless the caller asks for ``cpu``; no CUDA raises).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, streams, tree
from repro_torch.configs.base import CPSLConfig, SimCfg
from repro_torch.core import latency as lt
from repro_torch.core.channel import NetworkCfg, NetworkState
from repro_torch.core.cpsl import CPSL, to_device
from repro_torch.core.latency import CutProfile
from repro_torch.core.splitting import make_split_model
from repro_torch.data.pipeline import DeviceResidentDataset, batch_seed
from repro_torch.sim.controller import Plan, TwoTimescaleController
from repro_torch.sim.dynamics import DynamicsCfg, NetworkProcess
from repro_torch.telemetry import TraceWriter


def device_round_energy(plan: Plan, net, ncfg: NetworkCfg, prof: CutProfile,
                        B: int, L: int, p_compute_w: float, p_tx_w: float
                        ) -> dict:
    """Per-device energy (J) for one executed round: compute power times
    FP+BP time plus transmit power times uplink airtime (smashed data each
    local epoch + final model upload). Returns {global_id: joules}."""
    c = prof.at(plan.v)
    out = {}
    for cluster, x in zip(plan.clusters, plan.xs):
        for i, k in zip(cluster, np.asarray(x, dtype=np.float64)):
            f = net.f[i] * ncfg.kappa
            r = net.rate[i]
            t_comp = L * B * (c["gamma_dF"] + c["gamma_dB"]) / f
            t_tx = (L * B * c["xi_s"] + c["xi_d"]) / (k * r)
            out[int(plan.ids[i])] = (p_compute_w * t_comp
                                     + p_tx_w * t_tx)
    return out


class SimEngine:
    """Runs CPSL training end-to-end under simulated wireless dynamics.

    ``model`` names a splittable model ("lenet" or a zoo config); the
    engine owns (re)building the split at each cut-layer switch. ``dataset``
    must expose ``cluster_batch(devices, seed=...)`` (see
    ``data.pipeline.CPSLDataset``); global device ids are mapped onto its
    shards modulo the shard count (taken from ``n_data_shards`` or the
    dataset's ``device_indices``), so late arrivals get data too. Without
    either, ids pass through unmapped — only safe if the dataset accepts
    arbitrary ids (e.g. ``LMClusterData`` sized for the churn ceiling).

    The records are the reference's; the host times of each executed
    round go to ``timings`` instead: ``plan_ms`` (cut selection, slot plan,
    repair and pricing on the host), ``train_ms`` (the training round,
    synced) and ``wall_ms`` (the whole round).
    """

    def __init__(self, model, dataset, prof: CutProfile, ncfg: NetworkCfg,
                 dcfg: DynamicsCfg, scfg: SimCfg, ccfg: CPSLConfig,
                 eval_fn: Optional[Callable] = None,
                 train: bool = True, n_data_shards: Optional[int] = None,
                 device="cuda"):
        self.model, self.ds, self.prof = model, dataset, prof
        self.ncfg, self.dcfg, self.scfg, self.ccfg = ncfg, dcfg, scfg, ccfg
        self.eval_fn = eval_fn
        self.train = train
        self.device = resolve_device(device)
        # the trainer has exactly ccfg.cluster_size device slots per
        # cluster; a larger controller target would silently truncate
        # clusters out of the training batches (latency accounting is
        # unaffected — it always uses true cluster sizes)
        if train:
            assert scfg.cluster_size <= ccfg.cluster_size, (
                f"SimCfg.cluster_size={scfg.cluster_size} exceeds the "
                f"trainer's CPSLConfig.cluster_size={ccfg.cluster_size}")
        self.proc = NetworkProcess(ncfg, dcfg)
        self.controller = TwoTimescaleController(
            prof, ncfg, ccfg.batch_per_device, ccfg.local_epochs, scfg)
        self.trace: List[dict] = []
        self.timings: List[dict] = []
        self._writer = TraceWriter(None)
        self._n_shards = (n_data_shards
                          or len(getattr(dataset, "device_indices", []))
                          or None)
        # fused-round path: dataset mirrored on the device once; each
        # round ships only the (M, L, K, B) index table
        self._ds_dev: Optional[DeviceResidentDataset] = (
            DeviceResidentDataset.coerce(dataset, self.device)
            if train and ccfg.fused_round else None)

    # -- helpers --------------------------------------------------------------

    def _data_shard(self, gid: int) -> int:
        return gid % self._n_shards if self._n_shards else gid

    def _make_cpsl(self, v: int) -> CPSL:
        ccfg = dataclasses.replace(self.ccfg, cut_layer=v)
        return CPSL(make_split_model(self.model, v), ccfg)

    def _padded_clusters(self, plan: Plan) -> List[List[int]]:
        """Per-cluster data-shard ids, padded (by wrapping) to the
        trainer's fixed K slots — shared by the looped batch draw, the
        fused index table, and the eq.-8 weights so all three agree."""
        K = self.ccfg.cluster_size
        return [[self._data_shard(ids[i % len(ids)]) for i in range(K)]
                for ids in plan.global_clusters()]

    def _batch_fn(self, padded: List[List[int]], rnd: int):
        def batch_fn(m, l):  # noqa: E741
            b = self.ds.cluster_batch(
                padded[m], seed=batch_seed(self.scfg.seed, rnd, m, l))
            return {k: to_device(a, self.device) for k, a in b.items()}

        return batch_fn

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _emit(self, rec: dict):
        self.trace.append(rec)
        self._writer.emit(rec)

    # -- main loop ------------------------------------------------------------

    def run(self, generator: Optional[torch.Generator] = None,
            state: Optional[dict] = None):
        """Run ``scfg.rounds`` rounds; returns ``(state, trace)``.

        ``generator`` draws the model at each cut change (default
        ``streams.model_generator(scfg.seed)`` on the engine's device);
        ``state`` (optional) replaces the first cut's fresh init."""
        if generator is None and self.train:
            generator = streams.model_generator(self.scfg.seed, self.device)
        # fresh trace per run — carrying over records (in memory or on
        # disk) would interleave stale rounds into downstream recomputation
        self.trace = []
        self.timings = []
        self._writer = TraceWriter(self.scfg.trace_path, fresh=True)
        cpsl = None
        sim_time = 0.0
        for rnd in range(self.scfg.rounds):
            t0 = time.perf_counter()
            events = []
            net, ids = self.proc.snapshot()
            if len(ids) == 0:
                # arrivals must still happen or the network can never
                # repopulate after hitting zero
                events += self.proc.sample_arrivals()
                self._emit({"round": rnd, "skipped": "no active devices",
                            "events": [e.to_dict() for e in events]})
                self.proc.evolve()
                continue

            # 1. large timescale
            cut_means = None
            if rnd % self.scfg.epoch_len == 0 or self.controller.v is None:
                mu_f, mu_snr = self.proc.means_of(ids)
                v, cut_means = self.controller.select_cut(mu_f, mu_snr, rnd)
                if self.train and (cpsl is None or cpsl.ccfg.cut_layer != v):
                    first = cpsl is None
                    cpsl = self._make_cpsl(v)
                    if first and state is not None:
                        state = tree.map(lambda t: t.to(self.device), state)
                    else:
                        state = cpsl.init_state(generator)

            # 2. small timescale
            plan = self.controller.plan_slot(net, ids, rnd)
            planned_latency = plan.latency   # optimizer's pre-repair prediction

            # 3. mid-round departures -> stale-decision repair
            departures = self.proc.sample_departures(rnd)
            events += departures
            if departures:
                plan = self.controller.repair(
                    plan, net, [e.device for e in departures])
            if not plan.clusters:
                events += self.proc.sample_arrivals()
                self._emit({"round": rnd, "skipped": "all devices departed",
                            "events": [e.to_dict() for e in events]})
                self.proc.evolve()
                continue

            # 4. wireless cost of the executed plan (eqs. 15-25)
            latency = lt.round_latency(
                plan.v, plan.clusters, plan.xs, net, self.ncfg, self.prof,
                self.ccfg.batch_per_device, self.ccfg.local_epochs)
            sim_time += latency
            plan_ms = 1e3 * (time.perf_counter() - t0)

            # 5. the training round
            rec = {"round": rnd, "v": plan.v, "stale": plan.stale,
                   "n_active": len(ids),
                   "ids": ids, "f": net.f, "rate": net.rate,
                   "clusters": [list(c) for c in plan.clusters],
                   "clusters_global": plan.global_clusters(),
                   "xs": [np.asarray(x) for x in plan.xs],
                   "planned_latency_s": planned_latency,
                   "latency_s": float(latency),
                   "sim_time_s": float(sim_time)}
            if cut_means is not None:
                rec["cut_means"] = cut_means
            train_ms = 0.0
            if self.train:
                t1 = time.perf_counter()
                padded = self._padded_clusters(plan)
                if self._ds_dev is not None:
                    idx = self._ds_dev.round_index_table(
                        padded, self.scfg.seed, rnd,
                        self.ccfg.local_epochs)
                    state, metrics = cpsl.run_round_fused(
                        state, self._ds_dev.data, idx,
                        self._ds_dev.cluster_weights(padded))
                    # the trace record is JSONL-serialized per round, so
                    # the engine syncs once here regardless
                    rec["loss"] = float(metrics["loss"])
                else:
                    sizes = (np.stack([self.ds.data_sizes(p)
                                       for p in padded])
                             if hasattr(self.ds, "data_sizes") else None)
                    state, metrics = cpsl.run_round(
                        state, self._batch_fn(padded, rnd),
                        n_clusters=len(plan.clusters), data_sizes=sizes)
                    rec["loss"] = metrics["loss"]
                self._sync()
                train_ms = 1e3 * (time.perf_counter() - t1)
                if self.eval_fn is not None:
                    rec["eval"] = self.eval_fn(cpsl, state)

            # 6. energy drain (may trigger depletion departures)
            joules = device_round_energy(
                plan, net, self.ncfg, self.prof, self.ccfg.batch_per_device,
                self.ccfg.local_epochs, self.dcfg.p_compute_w,
                self.dcfg.p_tx_w)
            events += self.proc.consume(list(joules), list(joules.values()))

            # 7. churn + fading evolution for the next slot
            events += self.proc.sample_arrivals()
            self.proc.evolve()

            rec["events"] = [e.to_dict() for e in events]
            self._emit(rec)
            self.timings.append({
                "round": rnd, "plan_ms": plan_ms, "train_ms": train_ms,
                "wall_ms": 1e3 * (time.perf_counter() - t0)})
        return state, self.trace


def recompute_trace_latencies(trace, prof: CutProfile, ncfg: NetworkCfg,
                              B: int, L: int) -> np.ndarray:
    """Re-derive each traced round's latency from the recorded network
    snapshot with ``core.latency.round_latency`` — the acceptance check
    that the engine's accounting matches the cost model. Accepts either
    in-memory trace records, parsed JSONL lines, or a whole
    ``sim.fleet.SimFleetRunner.run`` result (returns (E, T) then, with
    empty rounds recomputing to 0 — the episode-fleet oracle)."""
    if isinstance(trace, dict):          # episode-fleet result
        from repro_torch.sim.fleet import recompute_fleet_latencies
        return recompute_fleet_latencies(trace, prof, ncfg, B, L)
    out = []
    for rec in trace:
        # skipped rounds recompute to nothing; records without a network
        # snapshot (e.g. interleaved QoS records) are not rounds
        if rec.get("skipped") or "v" not in rec:
            continue
        net = NetworkState(f=np.asarray(rec["f"], dtype=np.float64),
                           rate=np.asarray(rec["rate"], dtype=np.float64))
        out.append(lt.round_latency(
            rec["v"], rec["clusters"],
            [np.asarray(x) for x in rec["xs"]], net, ncfg, prof, B, L))
    return np.asarray(out)
