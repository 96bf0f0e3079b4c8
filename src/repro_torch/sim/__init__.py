"""repro_torch.sim — the replicated planner of ``repro.sim``.

  batched.py     vectorized candidate-allocation evaluation (bit-identical
                 to the scalar ``core.latency.cluster_latency``), fast
                 greedy/Gibbs built on it, and the replicated planner:
                 lockstep multi-chain Gibbs, hierarchical (bucketed) Gibbs
                 and fully batched SAA over ``core.latency.PartitionBatch``.

The reference's ``controller``, ``dynamics``, ``engine`` and ``fleet``
come with the simulator slice.
"""
from repro_torch.sim.batched import (BatchedClusterEvaluator,
                                     HierarchicalResult, MultiChainResult,
                                     PartitionBatch,
                                     gibbs_clustering_batched,
                                     gibbs_clustering_multichain,
                                     greedy_spectrum_batched,
                                     hierarchical_gibbs_clustering,
                                     saa_cut_selection_batched)

__all__ = [
    "BatchedClusterEvaluator", "PartitionBatch", "MultiChainResult",
    "HierarchicalResult", "greedy_spectrum_batched",
    "gibbs_clustering_batched", "gibbs_clustering_multichain",
    "hierarchical_gibbs_clustering", "saa_cut_selection_batched",
]
