"""Loopback CPSL deployment through the PyTorch port: real worker
processes, QoS, crossval (the port's copy of ``examples/rt_loopback.py``).

Stands the paper's CPSL schedule up as an actual deployment on localhost
— one server plus 4 device worker processes (2 clusters x 2 devices),
each process doing its numerics on the card in a CUDA context of its own
(``--device cpu`` runs them on the CPU) — with the eq. 15-25 wireless
times injected as send delays so the measured wall-clock exhibits the
schedule the simulator predicts. A fault round demonstrates the straggler
policy: device 3 drops its model upload in round 1 and is excluded from
FedAvg with simulated-dropout semantics (asserted).

With ``--chaos`` it instead runs the elastic-recovery drill: a seeded
``chaos_schedule`` SIGKILLs one worker mid-round AND the server at a round
boundary; worker respawn + cluster retry + WAL crash-resume put the run
back together, and the script asserts the final params are bit-exact with
the fault-free in-process reference.

Artifacts land in ``$RT_OUT_DIR`` (default ``rt_example`` under the
system's temporary directory):
  trace.jsonl     round records (measured wall_s + planned latency)
                  interleaved with per-device QoS phase timings
  crossval.json   measured vs predicted round latency, side by side
  chaos.json      (--chaos) the replayable injected-fault schedule

    PYTHONPATH=src python examples/torch_rt_loopback.py [--device cpu]
    PYTHONPATH=src python examples/torch_rt_loopback.py --chaos
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch import tree
from repro_torch.rt.crossval import crossval_report
from repro_torch.rt.faults import FaultRule, chaos_schedule
from repro_torch.rt.orchestrator import (RTConfig, loopback_reference,
                                         run_elastic, run_loopback)
from repro_torch.rt.protocol import MsgType


def _out_dir() -> str:
    out = os.environ.get("RT_OUT_DIR",
                         os.path.join(tempfile.gettempdir(), "rt_example"))
    os.makedirs(out, exist_ok=True)
    return out


def main(device: str):
    out_dir = _out_dir()
    trace = os.path.join(out_dir, "trace.jsonl")
    cfg = RTConfig(
        n_devices=4, cluster_size=2, rounds=3, local_epochs=1, batch=8,
        n_train=600, n_test=64, samples_per_device=80, seed=0,
        delay_scale=0.05,              # inject scaled eq. 15-25 delays
        phase_timeout_s=6.0, rpc_timeout_s=1.0, retries=2, backoff_s=0.2,
        # device 3 never delivers its round-1 model upload
        faults={3: [FaultRule("drop", msg_types=(int(MsgType.AGG),),
                              rounds=(1,))]},
        trace_path=trace, device=device)

    print(f"spawning {cfg.n_devices} device workers "
          f"({cfg.n_clusters} clusters x {cfg.cluster_size}) on {device}...")
    state, records = run_loopback(cfg)

    rounds = [r for r in records if r.get("kind") != "qos"]
    qos = [r for r in records if r.get("kind") == "qos"]
    print(f"\n{'round':>5} {'loss':>8} {'wall_s':>8} {'predicted_s':>12} "
          f"{'dropped':>8}")
    for r in rounds:
        print(f"{r['round']:>5} {r['loss']:>8.4f} {r['wall_s']:>8.3f} "
              f"{r['latency_s'] * cfg.delay_scale:>12.3f} "
              f"{str(r['dropped']):>8}")
    assert [r["dropped"] for r in rounds] == [[], [3], []], \
        "the fault round should drop device 3, and only it"

    report = crossval_report(records,
                             path=os.path.join(out_dir, "crossval.json"))
    print(f"\nQoS records: {len(qos)} "
          f"(phases: {sorted({q['phase'] for q in qos})})")
    print("crossval summary:", json.dumps(report["summary"], indent=2))
    print(f"\nartifacts: {trace}, {out_dir}/crossval.json")
    print(f"final step counter: {int(state['step'])}")


def main_chaos(device: str):
    """Chaos drill: seeded worker + server SIGKILLs, full recovery,
    bit-exact assert against the fault-free reference."""
    out_dir = _out_dir()
    trace = os.path.join(out_dir, "trace.jsonl")
    rounds = 3
    plan = chaos_schedule(seed=int(os.environ.get("RT_CHAOS_SEED", "7")),
                          rounds=rounds, n_devices=2,
                          kill_workers=1, kill_server=1)
    with open(os.path.join(out_dir, "chaos.json"), "w") as f:
        json.dump(plan.to_dict(), f, indent=2)
    print("chaos schedule:")
    for e in plan.events:
        print(f"  {e}")

    wal = os.path.join(out_dir, "wal")
    for name in os.listdir(wal) if os.path.isdir(wal) else []:
        os.remove(os.path.join(wal, name))     # a fresh run, not a resume
    cfg = RTConfig(
        n_devices=2, cluster_size=2, rounds=rounds, local_epochs=1,
        batch=4, n_train=400, n_test=64, samples_per_device=60, seed=0,
        phase_timeout_s=60.0, rejoin_timeout_s=180.0,
        reconnect_timeout_s=180.0,
        respawn=True, reconnect=True, cluster_retries=2,
        faults=plan.worker_faults,
        chaos_kill_server=plan.server_kill_rounds,
        wal_dir=wal, trace_path=trace, device=device)

    print(f"\nrunning {rounds} rounds under chaos "
          f"(respawn + rejoin + WAL resume) on {device}...")
    state, records = run_elastic(cfg)
    ref, ref_loss = loopback_reference(cfg)

    rnds = [r for r in records if r.get("kind") != "qos"]
    print(f"\n{'round':>5} {'loss':>8} {'dropped':>8} {'recovered':>10}")
    for r in rnds:
        print(f"{r['round']:>5} {r['loss']:>8.4f} "
              f"{str(r['dropped']):>8} {str(r.get('recovered', [])):>10}")

    assert [r["round"] for r in rnds] == list(range(rounds)), \
        f"rounds incomplete: {[r['round'] for r in rnds]}"
    assert all(r["dropped"] == [] for r in rnds), \
        "lossless recovery must drop nobody"
    for key in ("dev", "srv", "dev_opt", "srv_opt", "step"):
        for a, b in zip(tree.leaves(state[key]), tree.leaves(ref[key])):
            assert torch.equal(a, b), \
                f"{key}: chaos run diverged from fault-free reference"
    print(f"\nbit-exact recovery verified: final params identical to the "
          f"fault-free reference (last-round loss {ref_loss:.4f})")
    crossval_report(records, path=os.path.join(out_dir, "crossval.json"))
    print(f"artifacts: {trace}, {out_dir}/crossval.json, "
          f"{out_dir}/chaos.json")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--chaos", action="store_true",
                    help="elastic-recovery drill: seeded SIGKILLs + "
                         "bit-exact recovery assert")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server and every worker "
                         "(default cuda; cpu runs without a card)")
    args = ap.parse_args()
    main_chaos(args.device) if args.chaos else main(args.device)
