"""Deployment orchestrator: bind, spawn, plan, run, recover, tear down
(the port of ``repro.rt.orchestrator``).

``Orchestrator`` stands a full CPSL deployment up on localhost: it binds
a TCP port, spawns ``n_devices`` worker processes (``rt.device.
device_main`` via the 'spawn' context, never fork: each worker starts a
fresh interpreter, imports torch and touches CUDA only once its PLAN has
arrived, so every worker holds a CUDA context of its own), handshakes
(REGISTER -> PLAN -> READY), and then drives ``rounds`` CPSL rounds
through ``rt.server.RTServer``. The server and every worker run their
numerics on ``RTConfig.device`` (``"cuda"`` unless the caller asks for
``"cpu"``; without CUDA it raises, it never falls back).

Resource plans come from the SAME machinery the simulator uses:

  * ``plan="fixed"``    contiguous clusters of ``cluster_size`` with the
                        eq.-14 equal spectrum split — the deterministic
                        layout the bit-exactness tests pin against the
                        in-process reference;
  * ``plan="controller"`` a ``sim.controller.TwoTimescaleController`` in
                        fixed-cut mode re-runs Gibbs clustering + greedy
                        spectrum (Algs. 3/4) on the sampled network every
                        round, so the deployed layout tracks the paper's
                        resource management.

Either way the executed plan is priced with the eq. 15-25 cost model and
recorded per round (``planned_latency_s`` / ``latency_s``) next to the
measured ``wall_s`` — the pairing ``rt.crossval`` consumes. With
``delay_scale > 0`` the priced per-device times are also *injected* as
send delays (``faults.wireless_delay_rules``), so measured wall-clock
actually exhibits the wireless schedule instead of just predicting it.

Elastic recovery (everything off by default — legacy semantics intact):

  * a *membership thread* owns the listener for the whole run: it
    handshakes late REGISTERs and REJOINs (a crashed-and-restarted
    worker, or a worker that outlived a crashed server), monitors the
    worker processes and — with ``respawn`` — respawns dead ones with
    capped exponential backoff (``lifecycle.Backoff``), bumping the
    worker's *incarnation* so one-shot chaos faults don't re-fire;
  * ``arrivals={gid: round}`` holds a device out of the initial roster
    and spawns it one round before its entry boundary; planning is
    roster-aware (the network snapshot is sliced to the live roster),
    so the controller re-plans the layout when the roster grows;
  * ``wal_dir`` gives the server a write-ahead ``Checkpointer``:
    every round boundary commits {state, round}, and a restarted
    orchestrator (``resume_from=``) adopts the last committed record,
    truncates the (fsync'd) trace back to it, re-handshakes surviving
    workers via REJOIN, and continues — bit-exactly, because worker
    state between clusters is entirely derived from what the server
    ships (CLUSTER_START params + deterministic batch keys);
  * ``run_elastic`` supervises the whole thing from a parent process:
    it pins a concrete port, runs the orchestrator as a subprocess,
    restarts it with ``resume_from`` whenever it dies (e.g. the seeded
    ``chaos_kill_server`` SIGKILL after a commit), and reads the final
    state back from the WAL.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal
import socket
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from repro_torch import resolve_device, streams
from repro_torch.lifecycle import Backoff, retry_budget_s
from repro_torch.rt.device import build_shards, device_main, exact_numerics
from repro_torch.rt.faults import FaultRule, wireless_delay_rules
from repro_torch.rt.protocol import MsgType
from repro_torch.rt.server import RTServer
from repro_torch.rt.transport import Channel
from repro_torch.telemetry import TraceWriter, load_trace


@dataclass
class RTConfig:
    # deployment shape
    n_devices: int = 4
    cluster_size: int = 2            # K (fixed plan: contiguous clusters)
    rounds: int = 2
    # CPSL hyper-parameters (mirrors CPSLConfig; fused_step is forced off
    # — the runtime IS the explicit two-phase protocol)
    cut: int = 3                     # v
    local_epochs: int = 1            # L
    batch: int = 8                   # B
    optimizer: str = "sgd"
    lr_device: float = 0.05
    lr_server: float = 0.25
    momentum: float = 0.0
    weight_decay: float = 0.0
    seed: int = 0
    # data spec (rebuilt identically on server and every worker)
    n_train: int = 2000
    n_test: int = 256
    classes_per_device: int = 3
    samples_per_device: int = 120
    data_seed: Optional[int] = None  # None = seed
    # transport / robustness
    host: str = "127.0.0.1"
    port: int = 0                    # 0 = ephemeral; workers get the real one
    rpc_timeout_s: float = 5.0
    retries: int = 3
    backoff_s: float = 0.25
    backoff_max_s: float = 2.0       # cap on every retry/backoff sleep
    phase_timeout_s: float = 30.0
    straggler_policy: str = "drop"   # drop | wait  (see rt.server)
    heartbeat_s: float = 0.5
    hb_timeout_s: float = 2.5
    connect_timeout_s: float = 20.0
    ready_timeout_s: float = 300.0   # worker torch import + CUDA init +
                                     # warm-up budget
    warmup: bool = True
    device: str = "cuda"             # the server's and every worker's torch
                                     # device (PLAN carries it); "cuda"
                                     # without CUDA raises
    # resource management
    plan: str = "fixed"              # fixed | controller
    n_subcarriers: Optional[int] = None   # None = n_devices
    gibbs_iters: int = 30            # controller mode only
    # faults / telemetry
    faults: Dict[int, List] = field(default_factory=dict)
    delay_scale: float = 0.0         # >0: inject eq. 15-25 delays, scaled
    trace_path: Optional[str] = None
    # elastic recovery (see module docstring; all off by default)
    wal_dir: Optional[str] = None    # round-boundary WAL (crash-resume)
    wal_keep: int = 3
    respawn: bool = False            # respawn dead worker processes
    reconnect: bool = False          # workers re-dial a restarted server
    cluster_retries: int = 0         # lossless cluster retries on death
    rejoin_timeout_s: float = 60.0   # server-side wait for a comeback
    reconnect_timeout_s: float = 60.0  # worker-side re-dial budget
    rejoin_grace_s: float = 5.0      # resume: let orphans REJOIN before
                                     # respawning replacements
    respawn_backoff_s: float = 0.25
    arrivals: Dict[int, int] = field(default_factory=dict)  # gid -> round
    chaos_kill_server: Tuple[int, ...] = ()  # SIGKILL self after these
                                             # rounds commit (chaos)

    @property
    def n_clusters(self) -> int:
        return -(-self.n_devices // self.cluster_size)

    def ccfg(self):
        """The CPSL config of the deployment. ``unroll_clients``: a worker
        runs its client alone (a plain convolution), so the in-process
        reference loops over clients the same way instead of running the
        K clients as one grouped convolution."""
        from repro_torch.configs.base import CPSLConfig
        return CPSLConfig(
            cut_layer=self.cut, n_clusters=self.n_clusters,
            cluster_size=self.cluster_size, local_epochs=self.local_epochs,
            lr_device=self.lr_device, lr_server=self.lr_server,
            batch_per_device=self.batch, optimizer=self.optimizer,
            momentum=self.momentum, weight_decay=self.weight_decay,
            fused_step=False, unroll_clients=True)

    def data_spec(self) -> dict:
        return {"n_train": self.n_train, "n_test": self.n_test,
                "data_seed": (self.seed if self.data_seed is None
                              else self.data_seed),
                "n_devices": self.n_devices,
                "classes_per_device": self.classes_per_device,
                "samples_per_device": self.samples_per_device}

    def validate(self) -> "RTConfig":
        """Refuse timeout geometries that silently disagree: the device
        RPC retry budget (``lifecycle.retry_budget_s``) must stay under
        the server's phase deadline, or the server drops a device that
        is still faithfully retrying."""
        budget = retry_budget_s(self.rpc_timeout_s, self.retries,
                                self.backoff_s, self.backoff_max_s)
        if budget >= self.phase_timeout_s:
            raise ValueError(
                f"device RPC retry budget {budget:.2f}s "
                f"({self.retries + 1} reply waits of {self.rpc_timeout_s}s "
                f"+ capped backoff) >= phase_timeout_s="
                f"{self.phase_timeout_s}s: the server would drop a device "
                f"that is still retrying — raise phase_timeout_s or lower "
                f"retries/rpc_timeout_s/backoff_s")
        for gid, rnd in (self.arrivals or {}).items():
            if not (0 <= int(gid) < self.n_devices):
                raise ValueError(f"arrivals: unknown device {gid}")
            if not (0 <= int(rnd) <= self.rounds):
                raise ValueError(
                    f"arrivals[{gid}]={rnd} outside [0, rounds]")
        return self


class Orchestrator:
    def __init__(self, cfg: RTConfig, resume_from: Optional[str] = None,
                 incarnation_base: int = 0):
        """``resume_from`` names a WAL directory written by a previous
        (crashed) run of the same config — the orchestrator adopts its
        last committed round instead of starting fresh.
        ``incarnation_base`` floors the worker incarnation counter so
        respawns across server restarts keep advancing it (one-shot
        chaos faults are scoped by incarnation)."""
        self.cfg = cfg.validate()
        resolve_device(cfg.device)
        self._resume_from = resume_from
        self._inc_base = int(incarnation_base)
        # listener/port/server are bound once in start() before the
        # membership thread exists, then never rebound — safe to read
        # from both threads without a lock
        # guarded-by: none (bound in start() before the membership thread)
        self.listener: Optional[socket.socket] = None
        # guarded-by: none (bound in start() before the membership thread)
        self.port: Optional[int] = None
        self.procs: List[mp.Process] = []           # guarded-by: _mem_lock
        # guarded-by: none (bound in start() before the membership thread)
        self.server: Optional[RTServer] = None
        self.writer = TraceWriter(cfg.trace_path,
                                  fresh=(resume_from is None),
                                  fsync=cfg.wal_dir is not None)
        self.metrics: List[dict] = []
        # guarded-by: none (bound in start() before the membership thread)
        self.start_round = 0
        # written by the main round loop, read by the membership REJOIN
        # handshake; the rejoin protocol tolerates one-round staleness
        # guarded-by: none (GIL-atomic int snapshot)
        self._next_round = 0
        self._ctx = mp.get_context("spawn")  # fresh interpreters: CUDA
                                             # is never forked
        # Worker bookkeeping is written by BOTH the main thread
        # (start/stop) and the membership thread (_membership_tick), so
        # every access holds _mem_lock.
        self._mem_lock = threading.Lock()
        self._spawned: Dict[int, mp.Process] = {}   # guarded-by: _mem_lock
        self._incarnations: Dict[int, int] = {}     # guarded-by: _mem_lock
        self._respawn_at: Dict[int, float] = {}     # guarded-by: _mem_lock
        self._backoffs: Dict[int, Backoff] = {}     # guarded-by: _mem_lock
        self._rostered: Set[int] = set()
        self._arrival_waited: Set[int] = set()
        self._mem_stop = threading.Event()
        self._mem_thread: Optional[threading.Thread] = None

        from repro_torch.core.channel import device_means, sample_network
        from repro_torch.core.channel import NetworkCfg
        from repro_torch.core.latency import equal_split_x, round_latency
        from repro_torch.core.profile import lenet_profile

        cfgN = cfg.n_devices
        self.prof = lenet_profile()
        self.C = cfg.n_subcarriers or cfgN
        self.ncfg = NetworkCfg(n_devices=cfgN, n_subcarriers=self.C)
        mu_f, mu_snr = device_means(self.ncfg, seed=cfg.seed)
        self.net = sample_network(self.ncfg, mu_f, mu_snr,
                                  streams.network_draw_rng(cfg.seed))
        self._equal_split_x = equal_split_x
        self._round_latency = round_latency

        if cfg.plan == "controller":
            from repro_torch.configs.base import SimCfg
            from repro_torch.sim.controller import TwoTimescaleController
            self.ctrl = TwoTimescaleController(
                self.prof, self.ncfg, cfg.batch, cfg.local_epochs,
                SimCfg(cluster_size=cfg.cluster_size, seed=cfg.seed,
                       gibbs_iters=cfg.gibbs_iters))
            self.ctrl.v = cfg.cut    # fixed-cut mode: skip Alg. 2
        else:
            self.ctrl = None

    # -- planning --------------------------------------------------------

    def _arrival(self, gid: int) -> int:
        return int((self.cfg.arrivals or {}).get(gid, 0))

    def plan_round(self, rnd: int, roster: Optional[List[int]] = None):
        """The slot's resource plan over ``roster`` (default: everyone).
        Returns ``(plan, net)`` where ``net`` is the network snapshot
        sliced to the roster — ``plan.clusters`` index into it, which is
        the layout the trace records and ``recompute_trace_latencies``
        reprices."""
        from repro_torch.core.channel import NetworkState
        from repro_torch.sim.controller import Plan
        cfg = self.cfg
        if roster is None:
            roster = list(range(cfg.n_devices))
        ids = np.asarray(sorted(int(g) for g in roster))
        net = self.net if len(ids) == cfg.n_devices else NetworkState(
            f=self.net.f[ids], rate=self.net.rate[ids])
        if self.ctrl is not None:
            return self.ctrl.plan_slot(net, ids, rnd), net
        K = cfg.cluster_size
        n = len(ids)
        clusters = [list(range(m * K, min((m + 1) * K, n)))
                    for m in range(-(-n // K))]
        xs = [self._equal_split_x(len(c), self.C) for c in clusters]
        lat = self._round_latency(cfg.cut, clusters, xs, net,
                                  self.ncfg, self.prof, cfg.batch,
                                  cfg.local_epochs)
        return Plan(v=cfg.cut, clusters=clusters, ids=ids, xs=xs,
                    latency=float(lat)), net

    def _worker_faults(self) -> Dict[int, List[dict]]:
        cfg = self.cfg
        out: Dict[int, List[dict]] = {
            int(g): [r.to_dict() if isinstance(r, FaultRule) else dict(r)
                     for r in rules]
            for g, rules in (cfg.faults or {}).items()}
        if cfg.delay_scale > 0:
            plan0, net0 = self.plan_round(0)
            wireless = wireless_delay_rules(
                plan0, net0, self.ncfg, self.prof,
                cfg.batch, scale=cfg.delay_scale)
            for g, rules in wireless.items():
                out.setdefault(g, []).extend(r.to_dict() for r in rules)
        return out

    # -- membership ------------------------------------------------------

    def _spawn_worker(self, gid: int):
        """Called from start() (main) AND _membership_tick (membership
        thread) — all worker bookkeeping under _mem_lock; the slow
        Process.start() stays outside it."""
        cfg = self.cfg
        with self._mem_lock:
            inc = max(self._incarnations.get(gid, -1) + 1, self._inc_base)
            self._incarnations[gid] = inc
        wcfg = {"host": cfg.host, "port": self.port, "device": gid,
                "incarnation": inc,
                "faults": self._faults.get(gid, []),
                "rpc_timeout_s": cfg.rpc_timeout_s,
                "retries": cfg.retries, "backoff_s": cfg.backoff_s,
                "backoff_max_s": cfg.backoff_max_s,
                "heartbeat_s": cfg.heartbeat_s,
                "connect_timeout_s": cfg.connect_timeout_s,
                "plan_timeout_s": cfg.ready_timeout_s,
                "reconnect": cfg.reconnect,
                "reconnect_timeout_s": cfg.reconnect_timeout_s}
        p = self._ctx.Process(target=device_main, args=(wcfg,), daemon=True)
        p.start()
        with self._mem_lock:
            self._spawned[gid] = p
            self.procs.append(p)

    def _handshake(self, sock: socket.socket):
        """One incoming connection: REGISTER (fresh worker — needs the
        PLAN) or REJOIN (already-built worker reconnecting — gets the
        committed round/step and re-READYs immediately)."""
        try:
            ch = Channel(sock)
            mtype, msg = ch.recv(timeout=10.0)
            gid = int(msg["device"])
            if mtype == MsgType.REGISTER:
                self.server.attach(gid, ch)
                ch.send(MsgType.PLAN, self._plan_msg)
            elif mtype == MsgType.REJOIN:
                self.server.attach(gid, ch)
                ch.send(MsgType.REJOIN_ACK,
                        {"round": self._next_round,
                         "step": self.server._step})
            else:
                ch.close()
        except Exception:   # a bad peer must not end the membership loop
            try:
                sock.close()
            except OSError:
                pass

    def _membership_tick(self):
        """Spawn due arrivals; with ``respawn``, replace dead workers
        (capped backoff, bumped incarnation). An orphan worker that
        REJOINed on its own is left alone."""
        cfg = self.cfg
        now = time.monotonic()
        for gid in range(cfg.n_devices):
            a = self._arrival(gid)
            if a > self.start_round and self._next_round < a - 1:
                continue                      # arrival not due yet
            with self._mem_lock:
                p = self._spawned.get(gid)
            if p is not None and p.is_alive():
                continue
            if p is None:
                if self.server.is_attached_live(gid):
                    continue                  # orphan rejoined: alive
                if a > self.start_round:
                    self._spawn_worker(gid)   # late arrival, first spawn
                    continue
            with self._mem_lock:
                due = cfg.respawn and now >= self._respawn_at.get(gid, 0.0)
            if not due:
                continue
            self._spawn_worker(gid)
            with self._mem_lock:
                self._respawn_at[gid] = time.monotonic() + \
                    self._backoffs.setdefault(
                        gid, Backoff(cfg.respawn_backoff_s,
                                     cfg.backoff_max_s)).next()

    def _membership(self):
        self.listener.settimeout(0.2)
        while not self._mem_stop.is_set():
            try:
                sock, _ = self.listener.accept()
            except socket.timeout:
                sock = None
            except OSError:
                return          # listener closed: shutting down
            if sock is not None:
                self._handshake(sock)
            self._membership_tick()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        """Bind, restore (resume), spawn workers, handshake, warm up. A
        resumed start records its time to READY as a ``"resume"`` QoS
        record of the round it resumes at."""
        t_start = time.monotonic()
        cfg = self.cfg
        from repro_torch.core.cpsl import CPSL
        from repro_torch.core.splitting import make_split_model

        exact_numerics()
        _, labels, shards = build_shards(cfg.data_spec())
        cpsl = CPSL(make_split_model("lenet", cfg.cut), cfg.ccfg())

        wal = None
        wal_dir = self._resume_from or cfg.wal_dir
        if wal_dir is not None:
            from repro_torch.checkpoint.checkpointer import Checkpointer
            wal = Checkpointer(wal_dir, keep=cfg.wal_keep)
        self.server = RTServer(cfg, cpsl, shards, labels, self.writer,
                               wal=wal)

        if self._resume_from is not None and wal is not None \
                and wal.steps():
            restored = wal.restore(self.server.wal_template())
            self.start_round = int(restored["round"])
            self.server.adopt_state(restored["state"])
            if cfg.trace_path and os.path.exists(cfg.trace_path):
                # drop records of the crashed (uncommitted) round: they
                # will be re-emitted when the round re-runs
                kept = [r for r in load_trace(cfg.trace_path)
                        if int(r.get("round", -1)) < self.start_round]
                self.writer.rewrite(kept)
        self._next_round = self.start_round
        self._rostered = {g for g in range(cfg.n_devices)
                          if self._arrival(g) <= self.start_round}
        # guarded-by: none (bound in start() before the membership thread)
        self._faults = self._worker_faults()

        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((cfg.host, cfg.port))
        self.listener.listen(cfg.n_devices + 4)
        self.port = self.listener.getsockname()[1]

        # guarded-by: none (bound in start() before the membership thread)
        self._plan_msg = {"model": "lenet", "v": cfg.cut,
                          "local_epochs": cfg.local_epochs,
                          "batch": cfg.batch,
                          "seed": cfg.seed, "optimizer": cfg.optimizer,
                          "lr_device": cfg.lr_device,
                          "momentum": cfg.momentum,
                          "weight_decay": cfg.weight_decay,
                          "warmup": cfg.warmup, "device": cfg.device,
                          "data": cfg.data_spec()}

        resume = self._resume_from is not None
        now = time.monotonic()
        grace = cfg.rejoin_grace_s if resume else 0.0
        with self._mem_lock:
            self._respawn_at = {g: now + grace
                                for g in range(cfg.n_devices)}
        if not resume:
            for gid in sorted(self._rostered):
                self._spawn_worker(gid)

        self._mem_thread = threading.Thread(target=self._membership,
                                            daemon=True)
        self._mem_thread.start()

        ready = self.server.wait_ready(set(self._rostered),
                                       timeout=cfg.ready_timeout_s)
        if not ready:
            raise TimeoutError("no device ever became READY")
        if cfg.warmup:
            self.server.warmup()
        if resume:
            self.server.qos.emit(self.start_round, "resume",
                                 time.monotonic() - t_start)

    def _roster(self, rnd: int) -> List[int]:
        """The devices planned for round ``rnd``: the initial roster
        plus every arrival that is both due and READY (an arrival joins
        at a round *boundary*, never mid-round)."""
        for g in range(self.cfg.n_devices):
            if g not in self._rostered and self._arrival(g) <= rnd \
                    and g in self.server.ready:
                self._rostered.add(g)
        return sorted(self._rostered)

    def run(self):
        """Drive rounds ``start_round..rounds``; returns (final state,
        trace records). With a WAL, every round boundary is committed;
        ``chaos_kill_server`` rounds then SIGKILL this process — the
        ``run_elastic`` supervisor restarts it with ``resume_from``."""
        cfg = self.cfg
        for rnd in range(self.start_round, cfg.rounds):
            self._next_round = rnd
            for gid in range(cfg.n_devices):
                if gid not in self._rostered \
                        and 0 < self._arrival(gid) <= rnd \
                        and gid not in self._arrival_waited:
                    # arrival boundary: bounded wait for the newcomer
                    self._arrival_waited.add(gid)
                    self.server._await_rejoin({gid}, cfg.rejoin_timeout_s)
            plan, net = self.plan_round(rnd, self._roster(rnd))
            self.metrics.append(self.server.run_round(rnd, plan, net=net))
            self.server.commit_round(rnd)
            if rnd in tuple(cfg.chaos_kill_server or ()):
                os.kill(os.getpid(), signal.SIGKILL)
        return self.server.state, self.writer.records

    def stop(self, linger_s: float = 3.0):
        self._mem_stop.set()
        if self._mem_thread is not None:
            self._mem_thread.join(timeout=5.0)
        if self.server is not None:
            try:
                self.server.shutdown(linger_s)
            except (OSError, RuntimeError):
                pass
        with self._mem_lock:
            procs = list(self.procs)
        for p in procs:
            p.join(timeout=5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        if self.listener is not None:
            self.listener.close()


def run_loopback(cfg: RTConfig, resume_from: Optional[str] = None):
    """Stand a loopback deployment up, run it, tear it down. Returns
    (final CPSL state dict, list of trace record dicts)."""
    orch = Orchestrator(cfg, resume_from=resume_from)
    try:
        orch.start()
        return orch.run()
    finally:
        orch.stop()


# -- crash-resume supervision --------------------------------------------

def _free_port(host: str) -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _orchestrator_main(cfg_dict: dict, resume: bool,
                       incarnation_base: int):
    """Subprocess entrypoint for ``run_elastic`` (top-level so the spawn
    context can pickle it)."""
    cfg = RTConfig(**cfg_dict)
    orch = Orchestrator(cfg,
                        resume_from=(cfg.wal_dir if resume else None),
                        incarnation_base=incarnation_base)
    try:
        orch.start()
        orch.run()
    finally:
        orch.stop()


def run_elastic(cfg: RTConfig, max_restarts: int = 5):
    """Supervise a crash-resumable deployment: run the orchestrator as a
    subprocess and, whenever it dies (a chaos SIGKILL, or for real),
    restart it with ``resume_from=`` so it adopts the WAL's last
    committed round — surviving workers REJOIN, missing ones are
    respawned. Returns (final state restored from the WAL, trace
    records) — the same contract as ``run_loopback``."""
    if not cfg.wal_dir or not cfg.trace_path:
        raise ValueError(
            "run_elastic needs cfg.wal_dir and cfg.trace_path — the WAL "
            "and the fsync'd trace are what a restart resumes from")
    cfg.validate()
    device = resolve_device(cfg.device)
    if cfg.port == 0:
        # workers must re-find a RESTARTED server: pin a concrete port
        cfg = dataclasses.replace(cfg, port=_free_port(cfg.host))
    cfg_dict = asdict(cfg)
    ctx = mp.get_context("spawn")
    restarts = 0
    resume = False
    while True:
        p = ctx.Process(target=_orchestrator_main,
                        args=(cfg_dict, resume, restarts))
        p.start()
        p.join()
        if p.exitcode == 0:
            break
        restarts += 1
        resume = True
        if restarts > max_restarts:
            raise RuntimeError(
                f"orchestrator died {restarts} times "
                f"(last exit code {p.exitcode}); giving up")

    from repro_torch import tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.splitting import make_split_model
    cpsl = CPSL(make_split_model("lenet", cfg.cut), cfg.ccfg())
    st0 = cpsl.init_state(streams.model_generator(cfg.seed, device))
    template = {"state": tree.map(torch.zeros_like, st0),
                "round": torch.zeros((), dtype=torch.int32, device=device)}
    restored = Checkpointer(cfg.wal_dir, keep=cfg.wal_keep).restore(
        template)
    if restored is None or int(restored["round"]) < cfg.rounds:
        raise RuntimeError("run finished but the WAL never committed the "
                           "final round")
    return restored["state"], load_trace(cfg.trace_path)


# -- the in-process reference --------------------------------------------

def loopback_reference(cfg: RTConfig, zero_weight=None):
    """The in-process looped reference for cfg's fixed contiguous plan:
    what a fault-free (or losslessly *recovered*) deployment must
    reproduce bit for bit. ``zero_weight=(m, k)`` zeroes one device's
    eq.-8 weight in every round — the simulated-dropout semantics a
    genuinely-lost upload must match. Returns (state, last-round loss).
    """
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import CPSLDataset, batch_seed

    device = resolve_device(cfg.device)
    exact_numerics()
    x, y, shards = build_shards(cfg.data_spec())
    cpsl = CPSL(make_split_model("lenet", cfg.cut), cfg.ccfg())
    state = cpsl.init_state(streams.model_generator(cfg.seed, device))
    ds = CPSLDataset(x, y, shards, cfg.batch)
    K = cfg.cluster_size
    clusters = [list(range(m * K, min((m + 1) * K, cfg.n_devices)))
                for m in range(cfg.n_clusters)]
    sizes = [ds.data_sizes(c) for c in clusters]
    if zero_weight is not None:
        m, k = zero_weight
        sizes[m] = sizes[m].copy()
        sizes[m][k] = 0.0
    loss = None
    for rnd in range(cfg.rounds):
        def batch_fn(m, l, _rnd=rnd):  # noqa: E741
            b = ds.cluster_batch(clusters[m],
                                 seed=batch_seed(cfg.seed, _rnd, m, l))
            return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        state, metrics = cpsl.run_round(state, batch_fn, data_sizes=sizes)
        loss = metrics["loss"]
    return state, loss
