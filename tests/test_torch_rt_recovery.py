"""Elastic recovery of the port's deployment runtime on the CPU, held to
the reference's contract:

- LOSSLESS recovery is invisible to the numerics: a worker SIGKILL'd
  mid-cluster and respawned (the cluster rolled back and retried), and a
  server SIGKILL'd at a round boundary and resumed from its WAL by
  ``run_elastic``, end with final params bit-exact with the fault-free
  ``loopback_reference``;
- a GENUINELY lost round member (nobody comes back) degrades to exactly
  the simulated-dropout semantics (eq.-8 weight zero).

These spawn real workers and, for resume, real orchestrator processes.
Every wait is bounded by the runtime's deadlines, set short here; a
watchdog alarm fails a test that outlives them, and its teardown
terminates any child the test left behind.
"""
import multiprocessing as mp
import signal

import pytest
import torch

from repro_torch.rt.faults import FaultRule, chaos_schedule
from repro_torch.rt.orchestrator import (loopback_reference, run_elastic,
                                         run_loopback)
from repro_torch.rt.protocol import MsgType
from test_torch_rt_loopback import (assert_state_bit_exact, cfg_of,
                                    one_thread, round_records)  # noqa: F401

WALL_S = 300              # a test's own bound, far above its ~5-15 s


@pytest.fixture(autouse=True)
def bounded():
    def expire(signum, frame):
        raise TimeoutError(f"rt recovery test exceeded {WALL_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(WALL_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        for p in mp.active_children():
            p.terminate()
            p.join(timeout=10)


def _cfg(**kw):
    base = dict(rounds=2, rejoin_timeout_s=90.0, reconnect_timeout_s=90.0)
    base.update(kw)
    return cfg_of(**base)


def _kill_rule(rnd: int, mtype=MsgType.SMASHED) -> FaultRule:
    """SIGKILL the worker's own process on its first ``mtype`` send of
    round ``rnd``, in incarnation 0 only (the respawn must not re-fire
    while the cluster is retried)."""
    return FaultRule("kill", msg_types=(int(mtype),), rounds=(rnd,),
                     times=1, incarnations=(0,))


def test_worker_kill_respawn_retry_bit_exact():
    """A worker SIGKILL'd at its first SMASHED of round 0 is respawned;
    the server rolls the cluster back and re-runs it with the rejoined
    member: bit-exact with the fault-free reference, the recovery
    recorded, nobody dropped."""
    cfg = _cfg(respawn=True, cluster_retries=2, faults={1: [_kill_rule(0)]})
    state, records = run_loopback(cfg)
    ref, _ = loopback_reference(cfg)
    assert_state_bit_exact(state, ref)
    rounds = round_records(records)
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[0]["dropped"] == [] and rounds[0]["recovered"] == [1]
    assert rounds[1]["dropped"] == [] and rounds[1]["recovered"] == []
    waits = [q for q in records if q.get("kind") == "qos"
             and q["phase"] == "rejoin_wait"]
    assert waits and all(q["ok"] for q in waits)


def test_chaos_server_and_worker_kill_resume_bit_exact(tmp_path):
    """The seeded chaos schedule (seed 7) SIGKILLs one worker mid-round
    AND the server after a round's WAL commit; with respawn, reconnect,
    cluster retries and ``run_elastic``'s WAL resume the run finishes
    every round bit-exact with the fault-free reference, and the
    surviving workers REJOIN the restarted server."""
    rounds = 3
    plan = chaos_schedule(seed=7, rounds=rounds, n_devices=2,
                          kill_workers=1, kill_server=1)
    assert {e["kind"] for e in plan.events} == {"kill_worker",
                                                "kill_server"}
    cfg = _cfg(rounds=rounds, respawn=True, reconnect=True,
               cluster_retries=2, faults=plan.worker_faults,
               chaos_kill_server=plan.server_kill_rounds,
               wal_dir=str(tmp_path / "wal"),
               trace_path=str(tmp_path / "trace.jsonl"))
    state, records = run_elastic(cfg)
    ref, ref_loss = loopback_reference(cfg)
    assert_state_bit_exact(state, ref)
    rnds = round_records(records)
    assert [r["round"] for r in rnds] == list(range(rounds))
    assert all(r["dropped"] == [] for r in rnds)
    assert rnds[-1]["loss"] == ref_loss
    resumes = [q for q in records if q.get("kind") == "qos"
               and q["phase"] == "resume"]
    assert [q["round"] for q in resumes] == \
        [r + 1 for r in plan.server_kill_rounds]


def test_genuinely_lost_matches_simulated_dropout():
    """A worker SIGKILL'd on its AGG send with recovery off is lost for
    the round: excluded from FedAvg with exactly the simulated-dropout
    semantics."""
    cfg = _cfg(rounds=1, faults={1: [_kill_rule(0, MsgType.AGG)]})
    state, records = run_loopback(cfg)
    ref, _ = loopback_reference(cfg, zero_weight=(0, 1))
    assert_state_bit_exact(state, ref)
    assert round_records(records)[0]["dropped"] == [1]
