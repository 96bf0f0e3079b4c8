"""repro_torch.rt — the multi-process CPSL deployment runtime (the port of
``repro.rt``).

Everything else in the repo *simulates* CPSL's wireless schedule; this
package *executes* it: N device worker processes and one server process
run real CPSL rounds over localhost sockets — devices run
``SplitModel.device_apply`` forward and ship serialized smashed
activations, the server runs ``server_loss``/backward and returns
cut-layer gradients, and the orchestrator drives the paper's
cluster-parallel-then-sequential schedule from a ``Plan`` produced by the
``sim.controller`` two-timescale planner. Every process does its numerics
on ``RTConfig.device`` (the card by default) in a CUDA context of its own.

Modules:
  protocol      length-prefixed msgpack frames, versioned msg types
  transport     framed Channel: timeouts, retry/backoff, fault hooks
  faults        deterministic delay/drop/disconnect/slow/kill injection
  qos           measured per-device phase timings (telemetry schema)
  device        the device worker process (``device_main``)
  server        server-side numerics + straggler drop-or-wait policy
  orchestrator  spawn/plan/drive/collect (``run_loopback``), elastic
                recovery (``run_elastic``: WAL crash-resume, worker
                respawn/rejoin, roster-aware replanning)
  crossval      measured vs sim-predicted round latency, side by side

Correctness contract: a loopback run reproduces the in-process looped
``CPSL.run_round`` (``loopback_reference``) bit for bit (same rng
streams, same batch index tables) — tests/test_torch_rt_loopback.py.
Recovery contract: a chaos run (seeded worker SIGKILLs + server SIGKILLs,
``faults.chaos_schedule``) that recovers losslessly ends with the SAME
final params bit for bit — tests/test_torch_rt_recovery.py.
"""
from repro_torch.rt.faults import (ChaosPlan, FaultInjector, FaultRule,
                                   chaos_schedule, wireless_delay_rules)
from repro_torch.rt.orchestrator import (Orchestrator, RTConfig,
                                         loopback_reference, run_elastic,
                                         run_loopback)
from repro_torch.rt.protocol import MsgType, ProtocolError

__all__ = ["FaultInjector", "FaultRule", "wireless_delay_rules",
           "ChaosPlan", "chaos_schedule",
           "Orchestrator", "RTConfig", "run_loopback", "run_elastic",
           "loopback_reference", "MsgType", "ProtocolError"]
