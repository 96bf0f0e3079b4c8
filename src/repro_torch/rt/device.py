"""The CPSL device worker process (the port of ``repro.rt.device``).

One worker = one wireless device. Lifecycle:

  1. dial the server (retry/backoff), REGISTER, receive the PLAN (cut
     layer, seeds, round layout, data spec, torch device);
  2. rebuild its world deterministically from the plan — the synthetic
     dataset + non-IID shards (``data.synthetic``) and the device-side
     split model — so nothing bulky ships at startup. CUDA is first
     touched here, after the PLAN: a spawned worker imports torch, never
     JAX or ``repro``;
  3. optional warm-up: one throwaway forward/backward on dummy params and
     batches (the CUDA context, cuDNN/cuBLAS handles, the allocator), then
     READY, which keeps measured QoS clean of first-call time. The data
     build and the warm-up are QoS records of round -1, shipped with the
     first model upload;
  4. serve CLUSTER_STARTs: for each local epoch draw the same batch the
     in-process ``CPSLDataset.cluster_batch`` would draw (same
     ``batch_seed`` stream, same member order — bit-exactness), run the
     forward, ship SMASHED, await GRAD (timeout + exponential-backoff
     resend), run backward + optimizer step; after L epochs upload the
     device model (AGG) with piggybacked QoS records and await AGG_ACK.

The numerics are phases 1 and 3 of ``CPSL.protocol_step_impl`` for one
client: the forward ``device_apply`` under ``torch.no_grad()``, then the
backward ``torch.autograd.grad`` of ``device_apply``'s output with the
server's gradient and the device optimizer's step. They reproduce the
in-process looped round (``unroll_clients``) bit for bit, given the same
cuDNN/cuBLAS choices in every process (``exact_numerics``).

Robustness: an ERROR reply (server dropped us as a straggler) or a new
CLUSTER_START mid-RPC aborts the current cluster and returns to the main
loop; SIGTERM (``lifecycle.GracefulStop``) finishes the in-flight RPC,
sends BYE, and exits cleanly.

Elastic recovery: with ``reconnect`` enabled, losing the server
connection (server crash, not SHUTDOWN) does not end the worker — it
re-dials the server port with backoff and re-handshakes with REJOIN
instead of REGISTER, because its model is already built; the REJOIN_ACK
tells it the committed round the resumed run continues from, and it
reports READY immediately (no rebuild, no warm-up). Fault rules are
filtered by the worker's *incarnation* (respawn count, passed by the
orchestrator), so one-shot chaos faults don't re-fire in a kill/respawn
loop. RPC retry backoff is capped (``lifecycle.retry_sleeps``) and the
total retry budget is validated against the server's straggler deadline
at config time.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, streams, tree
from repro_torch.lifecycle import Backoff, GracefulStop, retry_sleeps
from repro_torch.rt import protocol as pr
from repro_torch.rt.faults import FaultInjector, FaultRule, InjectedDisconnect
from repro_torch.rt.protocol import MsgType
from repro_torch.rt.qos import QoSMonitor
from repro_torch.rt.transport import Channel, RpcTimeout, connect_with_retry


def exact_numerics() -> None:
    """Deterministic cuDNN and full-f32 convolutions and products (no
    TF32). Every process of a deployment, and the one that runs the
    in-process reference, sets this, so all pick the same kernels: a
    fresh process's default lets cuDNN's convolutions use TF32."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_shards(spec: dict):
    """(images, labels, per-device index arrays) rebuilt deterministically
    from the plan's data spec — identical on server and every worker."""
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
    xtr, ytr, _, _ = synthetic_mnist(spec["n_train"], spec["n_test"],
                                     seed=spec["data_seed"])
    shards = non_iid_split(
        ytr, n_devices=spec["n_devices"],
        classes_per_device=spec.get("classes_per_device", 3),
        samples_per_device=spec["samples_per_device"],
        seed=spec["data_seed"])
    return xtr, ytr, shards


def member_batch_indices(device_indices, members: Sequence[int], B: int,
                         seed: int, rnd: int, m: int, l: int  # noqa: E741
                         ) -> List[np.ndarray]:
    """Per-member sample picks for (round, cluster, epoch) — entry for
    entry the draws ``CPSLDataset.cluster_batch(members,
    seed=batch_seed(seed, rnd, m, l))`` makes: one fresh ``default_rng``
    per (m, l), members drawn in slot order (draws are prefix-stable, so
    every worker reproduces the full cluster's stream and slices its own
    row; the server reuses the same picks for the labels)."""
    rng = streams.batch_rng(seed, rnd, m, l)
    picks = []
    for d in members:
        idx = device_indices[d]
        picks.append(rng.choice(idx, B, replace=len(idx) < B))
    return picks


def step_tensor(step: int, device) -> torch.Tensor:
    """The step counter as the in-process state holds it (0-d int32)."""
    return torch.tensor(step, dtype=torch.int32, device=device)


def sync(device) -> None:
    """Wait for the card (before a QoS time is read)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(t):
    """A tree of tensors as numpy arrays (one device-to-host copy each)."""
    return tree.map(lambda x: x.detach().cpu().numpy(), t)


def from_host(t, device):
    """A tree of arrays from the wire as tensors on ``device``."""
    return tree.map(lambda x: torch.as_tensor(x).to(device), t)


class _Aborted(Exception):
    """Current cluster abandoned (server moved on / shutdown / error)."""


class DeviceWorker:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.gid = int(cfg["device"])
        self.incarnation = int(cfg.get("incarnation", 0))
        self.injector = FaultInjector(
            [r for r in (FaultRule.from_dict(d)
                         for d in cfg.get("faults", []))
             if r.active_in(self.incarnation)])
        self.stop = GracefulStop().install()
        self.pending = deque()
        self.qos = QoSMonitor(device=self.gid)
        self._round: Optional[int] = None
        self._hb_stop = threading.Event()
        self.ch: Optional[Channel] = None

    # -- setup -----------------------------------------------------------

    def _connect_and_plan(self) -> dict:
        cfg = self.cfg
        sock = connect_with_retry(cfg["host"], cfg["port"],
                                  cfg.get("connect_timeout_s", 20.0))
        self.ch = Channel(sock, self.injector, round_fn=lambda: self._round)
        self.ch.send(MsgType.REGISTER, {"device": self.gid})
        mtype, plan = self.ch.recv(timeout=cfg.get("plan_timeout_s", 120.0))
        if mtype != MsgType.PLAN:
            raise pr.BadFrame(f"expected PLAN, got {mtype.name}")
        return plan

    def _build(self, plan: dict):
        from repro_torch import optim
        from repro_torch.core.splitting import make_split_model

        if plan["model"] != "lenet":
            raise ValueError(f"the runtime trains lenet, not "
                             f"{plan['model']!r}")
        self.plan = plan
        self.dev = resolve_device(plan["device"])
        exact_numerics()
        self.L = int(plan["local_epochs"])
        self.B = int(plan["batch"])
        self.seed = int(plan["seed"])
        t0 = time.monotonic()
        self.x, _, self.shards = build_shards(plan["data"])
        self.qos.emit(-1, "data", time.monotonic() - t0)
        split = make_split_model(plan["model"], int(plan["v"]))
        dev_opt = optim.make(plan["optimizer"], plan["lr_device"],
                             momentum=plan["momentum"],
                             weight_decay=plan["weight_decay"])

        # phases 1 and 3 of CPSL.protocol_step_impl, for one client
        def _fwd(dp, b):
            with torch.no_grad():
                return split.device_apply(dp, b)

        def _bwd(dp, dopt, step, b, g):
            dp = tree.map(lambda t: t.detach().requires_grad_(), dp)
            with torch.enable_grad():
                out, _ = split.device_apply(dp, b)
                grads = torch.autograd.grad(out, tree.leaves(dp),
                                            grad_outputs=g.reshape(out.shape))
            dp = tree.map(lambda t: t.detach(), dp)
            return dev_opt.step(tree.unflatten_like(dp, grads), dopt, dp,
                                step)

        self._fwd, self._bwd = _fwd, _bwd
        if plan.get("warmup", True):
            # one throwaway call of each: its results are discarded. The
            # first CUDA work of the process, so its QoS time holds the
            # context's creation.
            t0 = time.monotonic()
            p0 = split.init_device(streams.warmup_generator(self.dev))
            batch = {"image": torch.zeros((self.B, 28, 28, 1),
                                          device=self.dev)}
            self._fwd(p0, batch)
            g0 = torch.zeros(tuple(split.smashed_spec(self.B).shape),
                             device=self.dev)
            self._bwd(p0, dev_opt.init(p0), step_tensor(0, self.dev), batch,
                      g0)
            sync(self.dev)
            self.qos.emit(-1, "warmup", time.monotonic() - t0)

    def _start_heartbeat(self):
        interval = self.cfg.get("heartbeat_s", 0.5)
        ch = self.ch     # bind THIS channel: after a reconnect the old
                         # thread dies on the closed socket instead of
                         # silently adopting the new one

        def hb():
            while not self._hb_stop.wait(interval):
                try:
                    ch.send(MsgType.HEARTBEAT,
                            {"device": self.gid, "t": time.monotonic()})
                except (pr.ProtocolError, InjectedDisconnect, OSError):
                    return

        threading.Thread(target=hb, daemon=True).start()

    # -- RPC -------------------------------------------------------------

    def _rpc(self, send_type: MsgType, payload, match) -> dict:
        """Send and await the matching reply, resending with exponential
        backoff on timeout. Raises _Aborted when the server moved on
        (new CLUSTER_START / SHUTDOWN pushed to pending, or ERROR), and
        after exhausting retries."""
        cfg = self.cfg
        timeout = cfg.get("rpc_timeout_s", 5.0)
        retries = int(cfg.get("retries", 3))
        sleeps = retry_sleeps(retries, cfg.get("backoff_s", 0.25),
                              cap=cfg.get("backoff_max_s", 2.0))
        for attempt in range(retries + 1):
            if attempt:
                time.sleep(sleeps[attempt - 1])
            self.ch.send(send_type, dict(payload, attempt=attempt))
            deadline = time.monotonic() + timeout
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    mtype, msg = self.ch.recv(timeout=left)
                except RpcTimeout:
                    break
                if mtype in (MsgType.CLUSTER_START, MsgType.SHUTDOWN):
                    self.pending.append((mtype, msg))
                    raise _Aborted("server moved on")
                if mtype == MsgType.ERROR:
                    raise _Aborted(msg.get("reason", "server error"))
                if match(mtype, msg):
                    return msg
                # stale reply from an earlier attempt/epoch: ignore
        raise _Aborted(f"no reply to {send_type.name} "
                       f"after {retries + 1} attempts")

    # -- cluster participation -------------------------------------------

    def _run_cluster(self, msg: dict):
        rnd, m, k = int(msg["round"]), int(msg["m"]), int(msg["k"])
        members = [int(d) for d in msg["members"]]
        step0 = int(msg["step"])
        self._round = rnd
        dev = from_host(msg["dev"], self.dev)
        dopt = from_host(msg["dev_opt"], self.dev)

        for l in range(self.L):  # noqa: E741
            picks = member_batch_indices(self.shards, members, self.B,
                                         self.seed, rnd, m, l)
            batch = {"image": torch.from_numpy(self.x[picks[k]])
                     .to(self.dev)}
            self.injector.sleep_compute(rnd)
            t0 = time.monotonic()
            smashed, _ = self._fwd(dev, batch)
            smashed = smashed.cpu().numpy()        # syncs the card
            self.qos.emit(rnd, "fwd", time.monotonic() - t0,
                          cluster=m, epoch=l, slot=k)
            t0 = time.monotonic()
            reply = self._rpc(
                MsgType.SMASHED,
                {"round": rnd, "m": m, "epoch": l, "k": k,
                 "device": self.gid, "smashed": smashed},
                lambda mt, ms, l=l: (mt == MsgType.GRAD  # noqa: E741
                                     and ms.get("round") == rnd
                                     and ms.get("m") == m
                                     and ms.get("epoch") == l))
            self.qos.emit(rnd, "grad_wait", time.monotonic() - t0,
                          cluster=m, epoch=l, slot=k,
                          bytes=smashed.nbytes)
            t0 = time.monotonic()
            dev, dopt = self._bwd(dev, dopt, step_tensor(step0 + l, self.dev),
                                  batch, torch.as_tensor(reply["g"])
                                  .to(self.dev))
            sync(self.dev)
            self.qos.emit(rnd, "bwd", time.monotonic() - t0,
                          cluster=m, epoch=l, slot=k)

        self._rpc(
            MsgType.AGG,
            {"round": rnd, "m": m, "k": k, "device": self.gid,
             "dev": to_host(dev), "dev_opt": to_host(dopt),
             "qos": self.qos.drain()},
            lambda mt, ms: (mt == MsgType.AGG_ACK
                            and ms.get("round") == rnd
                            and ms.get("m") == m))

    # -- main loop -------------------------------------------------------

    def _serve(self):
        """Dispatch loop on the current channel; returns on clean
        SHUTDOWN (or triggered stop), raises on connection loss."""
        while not self.stop:
            if self.pending:
                mtype, msg = self.pending.popleft()
            else:
                try:
                    mtype, msg = self.ch.recv(timeout=0.5)
                except RpcTimeout:
                    continue
            if mtype == MsgType.SHUTDOWN:
                self.ch.send(MsgType.BYE, {"device": self.gid})
                return
            if mtype == MsgType.CLUSTER_START:
                try:
                    self._run_cluster(msg)
                except _Aborted:
                    self.qos.drain()   # cluster abandoned: QoS stale
            # anything else (stale GRAD/ACK/ERROR) is ignored here

    def _rejoin(self) -> bool:
        """Re-dial the server after losing it and re-handshake with
        REJOIN (model already built, so no PLAN rebuild and no warm-up —
        READY follows immediately). The WHOLE handshake is retried with
        capped backoff until ``reconnect_timeout_s`` elapses, not just the
        TCP connect: racing a dying server's socket teardown can land a
        connect in a dead listener's backlog (accepted, then RST on first
        read), and a restarted server may be mid-bind — both are
        transient. Returns False only when the budget is exhausted — the
        worker then exits."""
        cfg = self.cfg
        self.pending.clear()
        self._round = None
        self.qos.drain()               # pre-crash QoS is unmatchable now
        deadline = time.monotonic() + cfg.get("reconnect_timeout_s", 30.0)
        backoff = Backoff(cfg.get("backoff_s", 0.25),
                          cap=cfg.get("backoff_max_s", 2.0))
        while not self.stop:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            if self._rejoin_once(left):
                return True
            time.sleep(min(backoff.next(),
                           max(0.0, deadline - time.monotonic())))
        return False

    def _rejoin_once(self, budget_s: float) -> bool:
        """One rejoin attempt: connect, REJOIN, await REJOIN_ACK (or a
        PLAN — server wants a full rebuild), READY. Any transport or
        protocol failure just fails this attempt."""
        cfg = self.cfg
        try:
            sock = connect_with_retry(cfg["host"], cfg["port"], budget_s)
            self.ch = Channel(sock, self.injector,
                              round_fn=lambda: self._round)
            self.ch.send(MsgType.REJOIN, {"device": self.gid,
                                          "incarnation": self.incarnation})
            mtype, msg = self.ch.recv(
                timeout=min(budget_s, cfg.get("plan_timeout_s", 120.0)))
            if mtype == MsgType.PLAN:
                self._build(msg)       # server asked for a full rebuild
            elif mtype != MsgType.REJOIN_ACK:
                return False
            self.ch.send(MsgType.READY, {"device": self.gid})
        except (pr.ProtocolError, RpcTimeout, OSError):
            return False
        self._start_heartbeat()
        return True

    def run(self):
        plan = self._connect_and_plan()
        self._build(plan)
        self.ch.send(MsgType.READY, {"device": self.gid})
        self._start_heartbeat()
        try:
            while True:
                try:
                    self._serve()
                    return             # SHUTDOWN / stop: clean exit
                except (pr.ConnectionClosed, pr.TruncatedFrame,
                        InjectedDisconnect, OSError):
                    if not self.cfg.get("reconnect", False) or self.stop:
                        return
                    if not self._rejoin():
                        return
        finally:
            self._hb_stop.set()
            try:
                self.ch.close()
            except OSError:
                pass


def device_main(cfg: dict):
    """Spawn entrypoint (top-level so multiprocessing can pickle it)."""
    DeviceWorker(cfg).run()
