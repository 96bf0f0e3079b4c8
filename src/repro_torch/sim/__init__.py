"""repro_torch.sim — event-driven wireless dynamics simulation for CPSL
(the port of ``repro.sim``).

Layers on top of ``repro_torch.core``:
  dynamics.py    Gauss-Markov correlated fading + compute drift, device
                 churn (arrival/departure) and per-device energy budgets —
                 generalizes the i.i.d. draws of ``core.channel``.
  batched.py     vectorized candidate-allocation evaluation (bit-identical
                 to the scalar ``core.latency.cluster_latency``) plus fast
                 greedy/Gibbs built on it, and the replicated planner:
                 lockstep multi-chain Gibbs, hierarchical (bucketed) Gibbs
                 and fully batched SAA over ``core.latency.PartitionBatch``.
  controller.py  online two-timescale controller wrapping Algs. 2-4 with a
                 stale-decision fallback for mid-round departures.
  engine.py      round executor coupling controller + latency model + the
                 PyTorch ``core.cpsl`` trainer; emits JSONL traces.
  fleet.py       episode fleets: E dynamic-network episodes as one batched
                 float64 tensor program — ports of the AR(1) dynamics and
                 the eq. (15)-(25) cost model (``PartitionBatchJ``),
                 fixed-shape equal/greedy/proposed policies, and
                 ``SimFleetRunner`` pricing a seeds x policy x cluster-size
                 x cut grid in one call on the card.
"""
from repro_torch.sim.batched import (BatchedClusterEvaluator,
                                     HierarchicalResult, MultiChainResult,
                                     PartitionBatch,
                                     gibbs_clustering_batched,
                                     gibbs_clustering_multichain,
                                     greedy_spectrum_batched,
                                     hierarchical_gibbs_clustering,
                                     saa_cut_selection_batched)
from repro_torch.sim.controller import Plan, TwoTimescaleController
from repro_torch.sim.dynamics import DynamicsCfg, Event, NetworkProcess
from repro_torch.sim.engine import SimEngine
from repro_torch.sim.fleet import (PartitionBatchJ, SimFleetRunner,
                                   fleet_trace_records,
                                   recompute_fleet_latencies)

__all__ = [
    "BatchedClusterEvaluator", "PartitionBatch", "MultiChainResult",
    "HierarchicalResult", "greedy_spectrum_batched",
    "gibbs_clustering_batched", "gibbs_clustering_multichain",
    "hierarchical_gibbs_clustering", "saa_cut_selection_batched",
    "Plan", "TwoTimescaleController",
    "DynamicsCfg", "Event", "NetworkProcess", "SimEngine",
    "PartitionBatchJ", "SimFleetRunner", "fleet_trace_records",
    "recompute_fleet_latencies",
]
