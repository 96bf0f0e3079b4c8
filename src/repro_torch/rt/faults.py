"""Deterministic fault injection for the deployment runtime (the port of
``repro.rt.faults``; its rules and schedules are the reference's).

A ``FaultRule`` matches outgoing messages on a device's channel (by
message type and round) or the device's compute phase, and fires a
bounded number of times — chaos tests stay reproducible because the
match counters are plain deterministic state, no randomness anywhere.

Kinds:
  delay        sleep ``delay_s`` before sending the matched message
               (wireless airtime / slow-link emulation)
  drop         swallow the matched message (the device believes it sent;
               exercises the retry/backoff path)
  disconnect   hard-close the socket on the matched send (mid-round
               device failure; exercises straggler drop + masked loss)
  slow         sleep ``delay_s`` before the device-side forward pass
               (slow-device emulation; exercises drop-or-wait policy)
  kill         SIGKILL the worker's own process on the matched send —
               a real, deterministic mid-round crash (no cleanup, no
               BYE; exercises respawn + lossless cluster retry)

Rules are per-process state, so a respawned worker would replay its
rules from scratch — ``incarnations`` scopes a rule to specific process
incarnations (the orchestrator passes the respawn count to each worker),
so a one-shot chaos kill doesn't re-fire forever in a kill/respawn loop.

``chaos_schedule`` draws a *seeded* chaos plan — worker SIGKILLs
mid-round, server SIGKILLs at round boundaries, and socket blackhole
windows (every send of a round swallowed) — as plain FaultRule /
round-list state, so a chaos run is exactly reproducible from its seed.

``wireless_delay_rules`` maps a sim ``Plan`` + ``NetworkState`` onto
per-device delay rules priced by the eq. 15-25 cost model, so loopback
wall-clock reflects the paper's wireless schedule: the SMASHED send
carries one local iteration's device time (tau_d + tau_s + tau_g +
tau_u) and the AGG upload carries the model uplink (tau_t). That is
what lets a benchmark *measure* the fig. 7 CPSL-vs-SL gap instead of
pricing it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import streams
from repro_torch.rt.protocol import MsgType


class InjectedDisconnect(RuntimeError):
    """Raised device-side after a 'disconnect' rule closes the socket."""


@dataclass
class FaultRule:
    kind: str                    # delay | drop | disconnect | slow | kill
    delay_s: float = 0.0
    msg_types: Optional[Tuple[int, ...]] = None   # None = any message
    rounds: Optional[Tuple[int, ...]] = None      # None = any round
    times: Optional[int] = None               # max firings; None = unlimited
    after: int = 0                            # skip this many matches first
    incarnations: Optional[Tuple[int, ...]] = None  # process respawn counts
                                              # the rule is active in;
                                              # None = every incarnation
    hits: int = field(default=0, compare=False)   # match counter (state)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "delay_s": self.delay_s,
                "msg_types": (None if self.msg_types is None
                              else [int(t) for t in self.msg_types]),
                "rounds": (None if self.rounds is None
                           else [int(r) for r in self.rounds]),
                "times": self.times, "after": self.after,
                "incarnations": (None if self.incarnations is None
                                 else [int(i) for i in self.incarnations])}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        kw = dict(d)
        for k in ("msg_types", "rounds", "incarnations"):
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        return cls(**kw)

    def active_in(self, incarnation: int) -> bool:
        return (self.incarnations is None
                or int(incarnation) in self.incarnations)

    def _fire(self) -> bool:
        """Count a match; True when this occurrence is inside the
        [after, after+times) firing window."""
        n = self.hits
        self.hits += 1
        if n < self.after:
            return False
        return self.times is None or n < self.after + self.times


class FaultInjector:
    """Per-device rule set, consulted by ``transport.Channel`` on every
    send and by the device worker before its forward pass."""

    def __init__(self, rules: Sequence[FaultRule] = ()):
        self.rules: List[FaultRule] = list(rules)

    def on_send(self, mtype: MsgType, rnd: Optional[int]
                ) -> Optional[Tuple[str, float]]:
        """First matching send-rule action for this message, as
        ``(kind, delay_s)``; None = send normally."""
        for r in self.rules:
            if r.kind == "slow":
                continue
            if r.msg_types is not None and int(mtype) not in r.msg_types:
                continue
            if r.rounds is not None and (rnd is None
                                         or int(rnd) not in r.rounds):
                continue
            if r._fire():
                return r.kind, r.delay_s
        return None

    def compute_delay(self, rnd: Optional[int]) -> float:
        """Total 'slow' sleep to apply before this round's forward."""
        total = 0.0
        for r in self.rules:
            if r.kind != "slow":
                continue
            if r.rounds is not None and (rnd is None
                                         or int(rnd) not in r.rounds):
                continue
            if r._fire():
                total += r.delay_s
        return total

    def sleep_compute(self, rnd: Optional[int]):
        d = self.compute_delay(rnd)
        if d > 0:
            time.sleep(d)


@dataclass
class ChaosPlan:
    """One seeded chaos schedule, in plain replayable state: per-device
    fault rules (worker SIGKILLs, blackhole windows) + the round
    boundaries after which the server SIGKILLs itself, plus a JSONable
    event list for artifacts/logs."""
    seed: int
    worker_faults: Dict[int, List[FaultRule]]
    server_kill_rounds: Tuple[int, ...]
    events: List[dict]

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "server_kill_rounds": [int(r) for r in
                                       self.server_kill_rounds],
                "events": self.events}


def chaos_schedule(seed: int, rounds: int, n_devices: int,
                   kill_workers: int = 1, kill_server: int = 1,
                   blackholes: int = 0) -> ChaosPlan:
    """Draw a deterministic chaos schedule from ``seed``.

    * ``kill_workers`` worker SIGKILLs: each picks a device and a round
      and kills the worker process on its first SMASHED or AGG send of
      that round (``incarnations=(0,)`` so the respawned process does
      not re-fire while retrying the same round);
    * ``kill_server`` server SIGKILLs at distinct round *boundaries*
      (after the WAL commit of the chosen round, never after the last
      round — that boundary has nothing left to recover);
    * ``blackholes`` per-device one-round windows in which every
      outgoing frame (uploads *and* heartbeats) is swallowed — the
      device is straggler-dropped for that round and rejoins at the
      next boundary.
    """
    rng = streams.chaos_rng(seed)
    worker_faults: Dict[int, List[FaultRule]] = {}
    events: List[dict] = []
    for _ in range(kill_workers):
        gid = int(rng.integers(n_devices))
        rnd = int(rng.integers(rounds))
        mtype = int(MsgType.SMASHED if rng.random() < 0.5 else MsgType.AGG)
        worker_faults.setdefault(gid, []).append(
            FaultRule("kill", msg_types=(mtype,), rounds=(rnd,), times=1,
                      incarnations=(0,)))
        events.append({"kind": "kill_worker", "device": gid, "round": rnd,
                       "on": MsgType(mtype).name})
    kill_rounds: List[int] = []
    eligible = list(range(max(0, rounds - 1)))
    for _ in range(min(kill_server, len(eligible))):
        rnd = eligible.pop(int(rng.integers(len(eligible))))
        kill_rounds.append(rnd)
        events.append({"kind": "kill_server", "round": rnd})
    for _ in range(blackholes):
        gid = int(rng.integers(n_devices))
        rnd = int(rng.integers(rounds))
        worker_faults.setdefault(gid, []).append(
            FaultRule("drop", rounds=(rnd,)))
        events.append({"kind": "blackhole", "device": gid, "round": rnd})
    return ChaosPlan(seed=seed, worker_faults=worker_faults,
                     server_kill_rounds=tuple(sorted(kill_rounds)),
                     events=events)


def wireless_delay_rules(plan, net, ncfg, prof, B: int,
                         scale: float = 1.0) -> Dict[int, List[FaultRule]]:
    """Per-device delay rules pricing the executed plan with the
    eq. 15-25 model (``{global_id: [rules]}``): each local iteration's
    device-side time rides on the SMASHED send, the end-of-cluster model
    upload on the AGG send. ``scale`` compresses wall-clock (e.g. 1e-3
    => simulated seconds become milliseconds) so benchmarks stay fast
    while preserving the schedule's *relative* geometry."""
    c = prof.at(plan.v)
    rules: Dict[int, List[FaultRule]] = {}
    for cluster, x in zip(plan.clusters, plan.xs):
        for i, xi in zip(cluster, np.asarray(x, dtype=np.float64)):
            f = net.f[i] * ncfg.kappa
            r = net.rate[i]
            tau_iter = (B * c["gamma_dF"] / f          # (16) device FP
                        + B * c["xi_s"] / (xi * r)     # (17) smashed UL
                        + c["xi_g"] / (xi * r)         # (20) grad DL
                        + B * c["gamma_dB"] / f)       # (21) device BP
            tau_t = c["xi_d"] / (xi * r)               # (23) model UL
            rules[int(plan.ids[i])] = [
                FaultRule("delay", delay_s=float(scale * tau_iter),
                          msg_types=(int(MsgType.SMASHED),)),
                FaultRule("delay", delay_s=float(scale * tau_t),
                          msg_types=(int(MsgType.AGG),)),
            ]
    return rules
