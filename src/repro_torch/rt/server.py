"""The CPSL server: owns the model state, drives clusters, drops stragglers
(the port of ``repro.rt.server``).

The server holds the SAME state dict ``CPSL.init_state`` builds (stacked
device rows, server params, both optimizer states, step counter, rng) on
its torch device and executes the paper's first-parallel-then-sequential
schedule against remote devices: per cluster it ships each member its
device-row params (CLUSTER_START — the eq. 15 model distribution),
collects the K smashed uploads, runs ONE server forward/backward +
optimizer step on the concatenated batch (eqs. 5-6: ``CPSL.server_phase``,
phase 2 of the in-process protocol step), returns per-slot cut-layer
gradients, and after L local epochs collects the model uploads (eq. 23)
and applies eq.-8 FedAvg — literally ``CPSL.fedavg``, the function the
in-process reference uses.

Straggler policy (per collection phase, every wait bounded):
  * a device whose connection drops (reader EOF) is dead immediately;
  * policy "drop": a device whose heartbeats go stale (``hb_timeout_s``)
    is dropped without waiting for the phase deadline;
  * everyone else gets until ``phase_timeout_s``, then is dropped for
    THIS round (it may rejoin next round — mirroring the per-round
    semantics of the simulated FedAvg straggler dropout).

Dropped-device semantics mirror ``CPSL.fedavg_impl`` exactly: the eq.-8
weight is zero and the stacked row holds its pre-cluster params (the
``0 * x`` contribution is float-exact). An epoch missing a smashed upload
runs the masked server loss (``sample_weight`` zeros on the dead rows);
the unmasked path, the bit-exact reference path, runs whenever nobody was
dropped.

Retransmits are idempotent: GRADs and AGG_ACKs are cached per (round,
cluster, epoch, device) and replayed on duplicate uploads; uploads the
server no longer wants get an ERROR so the device stops retrying.

Elastic recovery (all off by default):

  * ``cluster_retries > 0`` turns a member's mid-cluster *death*
    (connection lost — a SIGKILL'd worker, not a mere straggler) into a
    lossless retry: the cluster's state is rolled back to its entry
    snapshot, the server waits up to ``rejoin_timeout_s`` for the dead
    members to be respawned/REJOINed and READY again, and the whole
    cluster re-runs from epoch 0 — same (round, cluster, epoch) batch
    keys, same rolled-back params, so the retried cluster is bit-exact
    with the fault-free one. If nobody comes back in time it falls back
    to the masked-drop path (the genuinely-lost case).
  * ``wal`` (a ``checkpoint.Checkpointer``) makes every round boundary
    durable: ``commit_round`` writes {state, round} after each round, and
    ``adopt_state`` rehydrates a restarted server from the last committed
    record — the orchestrator's ``resume_from`` path. The format is the
    reference's checkpoint format.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Set

import numpy as np
import torch

from repro_torch import resolve_device, streams, tree
from repro_torch.rt import protocol as pr
from repro_torch.rt.device import (member_batch_indices, step_tensor, sync,
                                   to_host)
from repro_torch.rt.protocol import MsgType
from repro_torch.rt.qos import QoSMonitor
from repro_torch.telemetry import TraceWriter


class _ClusterRetry(Exception):
    """Raised inside a cluster attempt when its missing members all
    *died* (connection lost) and a lossless retry is still allowed."""

    def __init__(self, gids):
        self.gids = set(int(g) for g in gids)
        super().__init__(f"cluster members died: {sorted(self.gids)}")


def _stack_rows(rows, device):
    """K per-client trees (numpy arrays or tensors) as one K-stacked tree
    of tensors on ``device``."""
    return tree.map(lambda *ts: torch.stack(
        [torch.as_tensor(t) for t in ts]).to(device), *rows)


class RTServer:
    def __init__(self, cfg, cpsl, shards, labels, writer: TraceWriter,
                 wal=None):
        """``cfg`` is the orchestrator's RTConfig (duck-typed: timeouts,
        straggler policy, seed, device); ``cpsl`` a CPSL built with
        ``fused_step=False``; ``shards``/``labels`` the server's copy of
        the per-device index arrays and label array; ``wal`` an optional
        ``Checkpointer`` given round-boundary {state, round} records
        (crash-resume, see module docstring)."""
        self.cfg, self.cpsl = cfg, cpsl
        self.shards, self.labels = shards, labels
        self.writer = writer
        self.qos = QoSMonitor(writer=writer, device=-1)
        self.device = resolve_device(cfg.device)

        # guarded-by: main-thread
        self.state = cpsl.init_state(
            streams.model_generator(cfg.seed, self.device))
        # the membership REJOIN handshake reads this cross-thread; the
        # rejoin protocol tolerates one-round staleness
        # guarded-by: none (GIL-atomic int snapshot)
        self._step = int(self.state["step"])
        self.wal = wal

        # Connection roster. channels/last_seen/dead are written by the
        # orchestrator's membership thread (attach) while the main
        # round-driver thread reads them, so every access holds
        # _roster_lock (RLock: _send -> _mark_dead nests). Reader threads
        # never touch the roster — they only enqueue to inbox.
        self._roster_lock = threading.RLock()
        self.channels: Dict[int, object] = {}   # guarded-by: _roster_lock
        self.inbox: "queue.Queue" = queue.Queue()
        self.last_seen: Dict[int, float] = {}   # guarded-by: _roster_lock
        # dead = connection lost (a later re-attach revives the gid)
        self.dead: Set[int] = set()             # guarded-by: _roster_lock
        # ready = READY seen on the current connection; only the main
        # thread pumps the inbox, so READY handling is main-only
        self.ready: Set[int] = set()            # guarded-by: main-thread
        self._round_dropped: Set[int] = set()   # guarded-by: main-thread
        self._round_recovered: Set[int] = set()  # guarded-by: main-thread
        # GRAD/ACK replay caches: written and read exclusively by the
        # main thread's inbox pump (reader threads only inbox.put) —
        # tests/test_torch_rt_threading.py pins this root set
        self._grad_cache: Dict[tuple, dict] = {}  # guarded-by: main-thread
        self._ack_cache: Set[tuple] = set()       # guarded-by: main-thread

    # -- crash-resume ----------------------------------------------------

    def wal_template(self):
        """The tree shape of one WAL record (deserialize target)."""
        return {"state": tree.map(torch.zeros_like, self.state),
                "round": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def commit_round(self, rnd: int):
        """Durably record the state AFTER round ``rnd`` completed. The
        trace record for ``rnd`` is already on disk (fsync'd) when this
        runs, so resume truncation never loses a committed round."""
        if self.wal is not None:
            self.wal.save({"state": self.state,
                           "round": torch.tensor(rnd + 1,
                                                 dtype=torch.int32)},
                          step=rnd + 1)

    def adopt_state(self, state):
        """Rehydrate from a restored WAL record's state dict."""
        self.state = state
        self._step = int(state["step"])

    # -- connections -----------------------------------------------------

    # called-from: membership
    def attach(self, gid: int, channel):
        """Register a device channel and start its reader thread. A
        re-attach (REJOIN after a crash) replaces the old channel and
        revives the gid. Called from the orchestrator's membership
        thread concurrently with the main thread's round drive."""
        with self._roster_lock:
            old = self.channels.get(gid)
            self.channels[gid] = channel
            self.last_seen[gid] = time.monotonic()
            self.dead.discard(gid)
        if old is not None and old is not channel:
            try:
                old.close()
            except OSError:
                pass

        def reader():
            while True:
                try:
                    mtype, payload = channel.recv(timeout=None)
                except Exception:
                    # any failure ends this connection: carry the channel
                    # so death is attributed to THIS attachment — a
                    # replaced channel's dying reader must not take down
                    # its successor
                    self.inbox.put((gid, None, channel))
                    return
                self.inbox.put((gid, mtype, payload))

        threading.Thread(target=reader, daemon=True).start()

    def _send(self, gid: int, mtype: MsgType, payload):
        with self._roster_lock:
            if gid in self.dead:
                return
            ch = self.channels.get(gid)
        if ch is None:          # planned but never connected (arrival)
            self._mark_dead(gid)
            return
        try:
            # blocking I/O stays outside the roster lock so a slow
            # socket never stalls the membership thread's attach
            ch.send(mtype, payload)
        except (pr.ProtocolError, OSError):
            self._mark_dead(gid)

    def _mark_dead(self, gid: int):
        with self._roster_lock:
            self.dead.add(gid)
        self.ready.discard(gid)

    # called-from: membership
    def is_attached_live(self, gid: int) -> bool:
        """Roster snapshot for the orchestrator's membership tick: True
        iff ``gid`` has a registered channel and is not dead."""
        with self._roster_lock:
            return gid in self.channels and gid not in self.dead

    # -- warm-up ---------------------------------------------------------

    def warmup(self):
        """One throwaway call of the server phase (masked and unmasked)
        and of FedAvg on dummy data (cuDNN/cuBLAS handles, the
        allocator), so measured round QoS excludes first-call time. The
        results are discarded, so ``self.state`` is untouched."""
        K = self.cpsl.ccfg.cluster_size
        B = self.cpsl.ccfg.batch_per_device
        sm = torch.zeros(tuple(self.cpsl.split.smashed_spec(K * B).shape),
                         device=self.device)
        lab = torch.zeros((K * B,), dtype=torch.int32, device=self.device)
        st = self.state
        for flat in ({"label": lab},
                     {"label": lab,
                      "sample_weight": torch.ones((K * B,),
                                                  device=self.device)}):
            self.cpsl.server_phase(st["srv"], st["srv_opt"],
                                   step_tensor(0, self.device), sm, flat)
        self.cpsl.fedavg(st, np.ones((K,), np.float32))
        sync(self.device)

    # -- message plumbing ------------------------------------------------

    def _handle_stray(self, gid, mtype, payload, ctx):
        """Anything that isn't the upload the current phase wants:
        heartbeats update liveness, cached retransmits are replayed,
        the rest is ERRORed so devices stop retrying."""
        if mtype is None:
            with self._roster_lock:
                cur = self.channels.get(gid)
            if payload is None or payload is cur:
                self._mark_dead(gid)
            return
        with self._roster_lock:
            self.last_seen[gid] = time.monotonic()
        if mtype == MsgType.READY:
            self.ready.add(gid)
            return
        if mtype in (MsgType.HEARTBEAT, MsgType.BYE):
            return
        if mtype == MsgType.SMASHED:
            key = (payload.get("round"), payload.get("m"),
                   payload.get("epoch"), gid)
            cached = self._grad_cache.get(key)
            if cached is not None:
                self._send(gid, MsgType.GRAD, cached)
                return
        if mtype == MsgType.AGG:
            if (payload.get("round"), payload.get("m"), gid) \
                    in self._ack_cache:
                self._send(gid, MsgType.AGG_ACK,
                           {"round": payload["round"], "m": payload["m"]})
                return
            for rec in payload.get("qos") or []:
                self.writer.emit(rec)       # salvage telemetry anyway
        self._send(gid, MsgType.ERROR,
                   {"reason": f"not expecting {mtype.name} ({ctx})"})

    def _collect(self, want: Set[int], accept, ctx: str,
                 on_accept=None) -> Dict[int, dict]:
        """Wait for one upload per device in ``want``; every path is
        deadline-bounded (see module docstring for the policy).
        ``on_accept`` runs on first acceptance (e.g. immediate AGG_ACK,
        so a device never waits on its cluster-mates' uploads);
        duplicates of an upload already collected THIS phase are simply
        ignored — the device keeps retrying until the phase's reply."""
        cfg = self.cfg
        got: Dict[int, dict] = {}

        def handle(gid, mtype, payload):
            if mtype is not None and gid in want \
                    and accept(gid, mtype, payload):
                with self._roster_lock:
                    self.last_seen[gid] = time.monotonic()
                if gid not in got:
                    got[gid] = payload
                    if on_accept is not None:
                        on_accept(gid, payload)
            else:
                self._handle_stray(gid, mtype, payload, ctx)

        # Drain the backlog first: heartbeats queued while the server
        # was busy (warm-up, FedAvg, a previous cluster) must refresh
        # liveness BEFORE the straggler filter below consults it —
        # otherwise every device looks hb-stale at phase entry and the
        # phase gives up without waiting at all.
        while True:
            try:
                gid, mtype, payload = self.inbox.get_nowait()
            except queue.Empty:
                break
            handle(gid, mtype, payload)

        t0 = time.monotonic()
        hard = t0 + cfg.phase_timeout_s
        while True:
            with self._roster_lock:
                missing = want - set(got) - self.dead
                if cfg.straggler_policy == "drop":
                    now = time.monotonic()
                    missing = {g for g in missing
                               if now - self.last_seen[g]
                               <= cfg.hb_timeout_s}
            if not missing:
                break
            left = hard - time.monotonic()
            if left <= 0:
                break
            try:
                gid, mtype, payload = self.inbox.get(
                    timeout=min(left, 0.1))
            except queue.Empty:
                continue
            handle(gid, mtype, payload)
        return got

    def wait_ready(self, want: Set[int], timeout: float) -> Set[int]:
        """Block until every registered device reports READY (post
        warm-up); devices that never do are dead to the run."""
        ready: Set[int] = set()
        deadline = time.monotonic() + timeout
        while True:
            with self._roster_lock:
                pending = want - ready - self.dead
            if not pending:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                gid, mtype, payload = self.inbox.get(
                    timeout=min(left, 0.25))
            except queue.Empty:
                continue
            if mtype == MsgType.READY:
                ready.add(gid)
                self.ready.add(gid)
                with self._roster_lock:
                    self.last_seen[gid] = time.monotonic()
            else:
                self._handle_stray(gid, mtype, payload, "warmup")
        with self._roster_lock:
            lost = want - ready - self.dead
        for gid in lost:
            self._mark_dead(gid)
        return ready

    # -- rejoin ----------------------------------------------------------

    def _await_rejoin(self, gids: Set[int], timeout_s: float) -> bool:
        """Pump the inbox until every gid in ``gids`` is READY again on
        a fresh connection (the orchestrator's membership thread runs
        the REJOIN handshake and re-``attach``es), or the deadline
        passes."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._roster_lock:
                none_dead = not (set(gids) & self.dead)
            if none_dead and all(g in self.ready for g in gids):
                return True
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            try:
                gid, mtype, payload = self.inbox.get(
                    timeout=min(left, 0.25))
            except queue.Empty:
                continue
            self._handle_stray(gid, mtype, payload, "rejoin")

    def _purge_cluster_caches(self, rnd: int, m: int):
        """Drop the aborted attempt's idempotency caches so the retried
        cluster's replies are recomputed from the rolled-back state."""
        for key in [k for k in self._grad_cache
                    if k[0] == rnd and k[1] == m]:
            del self._grad_cache[key]
        self._ack_cache.difference_update(
            {k for k in self._ack_cache if k[0] == rnd and k[1] == m})

    # -- the round -------------------------------------------------------

    @staticmethod
    def _tree_row(tree_, k: int):
        return to_host(tree.map(lambda t: t[k], tree_))

    def _run_cluster(self, rnd: int, m: int, members: List[int],
                     step0: int) -> List:
        """One cluster, with up to ``cfg.cluster_retries`` lossless
        retries when members *die* mid-cluster (see module docstring).
        With retries at 0 (the default) this is exactly one attempt."""
        cfg = self.cfg
        retries = int(getattr(cfg, "cluster_retries", 0) or 0)
        st0 = self.state            # entry snapshot: rollback target
        for _ in range(retries):
            try:
                return self._run_cluster_once(rnd, m, members, step0,
                                              allow_retry=True)
            except _ClusterRetry as e:
                self.state = st0    # the aborted attempt may have
                                    # stepped the server params
                self._purge_cluster_caches(rnd, m)
                t0 = time.monotonic()
                ok = self._await_rejoin(
                    e.gids, float(getattr(cfg, "rejoin_timeout_s", 30.0)))
                self.qos.emit(rnd, "rejoin_wait",
                              time.monotonic() - t0, cluster=m, ok=ok)
                if ok:
                    self._round_recovered.update(e.gids)
                else:
                    break           # nobody came back: genuinely lost
        return self._run_cluster_once(rnd, m, members, step0,
                                      allow_retry=False)

    def _run_cluster_once(self, rnd: int, m: int, members: List[int],
                          step0: int, allow_retry: bool = False) -> List:
        """One cluster's L local epochs + FedAvg. Returns the per-epoch
        losses (device scalars). With ``allow_retry``, a collection
        phase whose missing members all *died* raises ``_ClusterRetry``
        instead of falling to the masked-drop path."""
        cfg, cpsl = self.cfg, self.cpsl
        K, B, L = len(members), cpsl.ccfg.batch_per_device, \
            cpsl.ccfg.local_epochs
        st = self.state
        with self._roster_lock:
            cluster_dead = {g for g in members if g in self.dead}
        if allow_retry and cluster_dead:
            raise _ClusterRetry(cluster_dead)

        live0 = [g for g in members if g not in cluster_dead]
        if not live0:
            return []
        for k, gid in enumerate(members):
            if gid in cluster_dead:
                continue
            self._send(gid, MsgType.CLUSTER_START,
                       {"round": rnd, "m": m, "k": k, "members": members,
                        "step": step0,
                        "dev": self._tree_row(st["dev"], k),
                        "dev_opt": self._tree_row(st["dev_opt"], k)})

        smash_shape = tuple(cpsl.split.smashed_spec(B).shape)
        losses = []
        for l in range(L):  # noqa: E741
            phase_t0 = time.monotonic()
            want = set(members) - cluster_dead

            def accept(gid, mtype, p, l=l):  # noqa: E741
                return (mtype == MsgType.SMASHED and p.get("round") == rnd
                        and p.get("m") == m and p.get("epoch") == l)

            got = self._collect(want, accept, f"r{rnd}m{m}l{l}")
            missing = want - set(got)
            with self._roster_lock:
                all_died = missing <= self.dead
            if allow_retry and missing and all_died:
                raise _ClusterRetry(missing)
            for gid in want:
                if gid in got:
                    self.qos.emit(rnd, "upload",
                                  time.monotonic() - phase_t0, device=gid,
                                  cluster=m, epoch=l, ok=True,
                                  attempt=got[gid].get("attempt"))
                else:
                    cluster_dead.add(gid)
                    self.qos.emit(rnd, "upload",
                                  time.monotonic() - phase_t0, device=gid,
                                  cluster=m, epoch=l, ok=False)

            if len(cluster_dead & set(members)) == K:
                return losses    # nobody left: cluster contributes nothing

            rows, weights, labels = [], [], []
            picks = member_batch_indices(self.shards, members, B,
                                         cfg.seed, rnd, m, l)
            for k, gid in enumerate(members):
                labels.append(self.labels[picks[k]])
                if gid in got:
                    rows.append(np.asarray(got[gid]["smashed"]))
                    weights.append(np.ones((B,), np.float32))
                else:
                    rows.append(np.zeros(smash_shape, np.float32))
                    weights.append(np.zeros((B,), np.float32))
            smashed_flat = torch.from_numpy(
                np.concatenate(rows, axis=0)).to(self.device)  # (K*B, ...)
            flat = {"label": torch.from_numpy(
                np.concatenate(labels).astype(np.int32)).to(self.device)}
            if cluster_dead & set(members):
                # masked loss ONLY after an actual drop — the unmasked
                # path is the bit-exact reference path
                flat["sample_weight"] = torch.from_numpy(
                    np.concatenate(weights)).to(self.device)

            t0 = time.monotonic()
            new_srv, new_opt, g_smashed, loss = cpsl.server_phase(
                st["srv"], st["srv_opt"], step_tensor(step0 + l, self.device),
                smashed_flat, flat)
            g = g_smashed.cpu().numpy().reshape((K,) + smash_shape)  # syncs
            self.qos.emit(rnd, "server", time.monotonic() - t0, cluster=m,
                          epoch=l)
            st = dict(st, srv=new_srv, srv_opt=new_opt)
            self.state = st
            losses.append(loss)

            for k, gid in enumerate(members):
                if gid in cluster_dead:
                    continue
                payload = {"round": rnd, "m": m, "epoch": l, "g": g[k]}
                self._grad_cache[(rnd, m, l, gid)] = payload
                self._send(gid, MsgType.GRAD, payload)

        # -- model upload + eq. 8 ----------------------------------------
        want = set(members) - cluster_dead

        def accept_agg(gid, mtype, p):
            return (mtype == MsgType.AGG and p.get("round") == rnd
                    and p.get("m") == m)

        agg_t0 = time.monotonic()

        def on_agg(gid, p):
            # ack on arrival: the device must not wait on cluster-mates
            self._ack_cache.add((rnd, m, gid))
            self._send(gid, MsgType.AGG_ACK, {"round": rnd, "m": m})
            for rec in p.get("qos") or []:
                self.writer.emit(rec)
            self.qos.emit(rnd, "model_up", time.monotonic() - agg_t0,
                          device=gid, cluster=m, ok=True)

        got = self._collect(want, accept_agg, f"r{rnd}m{m}agg", on_agg)
        missing = want - set(got)
        with self._roster_lock:
            all_died = missing <= self.dead
        if allow_retry and missing and all_died:
            raise _ClusterRetry(missing)
        for gid in missing:
            cluster_dead.add(gid)
            self.qos.emit(rnd, "model_up", time.monotonic() - agg_t0,
                          device=gid, cluster=m, ok=False)

        dev_rows, opt_rows, w = [], [], []
        for k, gid in enumerate(members):
            if gid in got:
                dev_rows.append(got[gid]["dev"])
                opt_rows.append(got[gid]["dev_opt"])
                w.append(float(len(self.shards[gid])))
            else:
                # pre-cluster row + zero eq.-8 weight: the 0*x
                # contribution is float-exact (CPSL.fedavg_impl)
                dev_rows.append(self._tree_row(st["dev"], k))
                opt_rows.append(self._tree_row(st["dev_opt"], k))
                w.append(0.0)
        st = dict(st, dev=_stack_rows(dev_rows, self.device),
                  dev_opt=_stack_rows(opt_rows, self.device))
        if any(x > 0 for x in w):
            st = cpsl.fedavg(st, np.asarray(w, np.float32))
        self.state = st
        with self._roster_lock:
            dead_now = set(self.dead)
        self._round_dropped.update(cluster_dead - dead_now)
        self._round_dropped.update(set(members) & dead_now)
        return losses

    def run_round(self, rnd: int, plan, net=None) -> dict:
        """Execute one CPSL round over the plan's clusters (sequentially,
        eq. 9) and emit the trace record. Returns round metrics."""
        t0 = time.monotonic()
        self._round_dropped = set()
        self._round_recovered = set()
        self._grad_cache.clear()
        losses = []
        L = self.cpsl.ccfg.local_epochs
        clusters_global = plan.global_clusters()
        for m, members in enumerate(clusters_global):
            step0 = self._step
            losses += self._run_cluster(rnd, m, members, step0)
            self._step = step0 + L
        self.state = dict(self.state,
                          step=step_tensor(self._step, self.device))

        loss = float(torch.stack(losses).mean()) if losses else None
        sync(self.device)
        wall = time.monotonic() - t0
        dropped = sorted(self._round_dropped)
        with self._roster_lock:
            n_dead = len(self.dead)
        rec = {"round": rnd, "v": plan.v, "stale": plan.stale,
               "n_active": len(plan.ids) - n_dead,
               "ids": plan.ids,
               "clusters": [list(c) for c in plan.clusters],
               "clusters_global": clusters_global,
               "xs": [np.asarray(x) for x in plan.xs],
               "planned_latency_s": plan.latency,
               "wall_s": wall, "dropped": dropped,
               "recovered": sorted(self._round_recovered), "source": "rt"}
        if net is not None:
            rec["f"], rec["rate"] = net.f, net.rate
            rec["latency_s"] = plan.latency
        if loss is not None:
            rec["loss"] = loss
        self.writer.emit(rec)
        self.qos.emit(rnd, "round", wall)
        return {"loss": loss, "dropped": dropped, "wall_s": wall}

    # -- teardown --------------------------------------------------------

    def shutdown(self, linger_s: float = 3.0):
        with self._roster_lock:
            gids = list(self.channels)
        for gid in gids:
            self._send(gid, MsgType.SHUTDOWN, {})
        deadline = time.monotonic() + linger_s
        bye = set()
        while True:
            with self._roster_lock:
                n_live = len(self.channels) - len(self.dead)
            if len(bye) >= n_live:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                gid, mtype, _ = self.inbox.get(timeout=min(left, 0.25))
            except queue.Empty:
                continue
            if mtype == MsgType.BYE:
                bye.add(gid)
        with self._roster_lock:
            chans = list(self.channels.values())
        for ch in chans:
            ch.close()
