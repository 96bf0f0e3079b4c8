"""Two-timescale resource management (paper §VII).

  Alg. 2: SAA cut-layer selection (large timescale).
  Alg. 3: greedy subcarrier allocation (diminishing gains).
  Alg. 4: Gibbs-sampling device clustering with embedded Alg. 3.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import streams
from repro_torch.core.channel import NetworkCfg, NetworkState, device_means, sample_network
from repro_torch.core.latency import CutProfile, PartitionBatch, cluster_latency


# --------------------------------------------------------------------------
# Alg. 3 — greedy subcarrier allocation for one cluster
# --------------------------------------------------------------------------

def greedy_spectrum(v: int, devices: Sequence[int], net: NetworkState,
                    ncfg: NetworkCfg, prof: CutProfile, B: int, L: int,
                    C: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Allocate C subcarriers to the cluster's devices: start at 1 each,
    then repeatedly give one to the device yielding the lowest resulting
    cluster latency — i.e. argmin_k Omega_k, which (the current latency
    Omega being fixed across candidates) equals the paper's
    argmax_k (Omega - Omega_k) largest-gain rule. Returns (x, D_m)."""
    C = ncfg.n_subcarriers if C is None else C
    K = len(devices)
    assert C >= K, "need at least one subcarrier per device"
    x = np.ones(K, dtype=np.int64)

    def lat(xv):
        return cluster_latency(v, devices, xv, net, ncfg, prof, B, L)

    cur = lat(x)
    if C == K:
        # exactly one subcarrier per device is the only feasible point
        return x, cur
    for _ in range(C - K):
        # paper Alg. 3 line 9: k* = argmax_k (Omega - Omega_k), realised
        # as argmin_k over candidate latencies Omega_k; all subcarriers
        # are allocated even when the gain is zero.
        cands = np.empty(K)
        for k in range(K):
            x[k] += 1
            cands[k] = lat(x)
            x[k] -= 1
        best_k = int(np.argmin(cands))
        x[best_k] += 1
        cur = cands[best_k]
    return x, cur


def greedy_spectrum_topk(v: int, devices: Sequence[int], net: NetworkState,
                         ncfg: NetworkCfg, prof: CutProfile, B: int, L: int,
                         C: Optional[int] = None, k: int = 16
                         ) -> Tuple[np.ndarray, float]:
    """Top-k-pruned Alg. 3: each greedy step evaluates candidate grants
    only for the ``min(k, K)`` devices with the largest straggler score
    (``PartitionBatch.device_scores`` — the latency bound the device's
    current allocation enforces on its cluster) instead of scanning all
    K devices. One extra subcarrier can only lower the cluster latency
    through the phase maxima, and only a near-max (high-score) device's
    term sits in them, so low-score devices are implausible winners.

    Exactness: with ``k >= K`` the pruned candidate set is all K devices
    in ascending index order, the candidate latencies come from the
    bit-exact ``PartitionBatch``, and ``argmin`` keeps the first-index
    tie-break — so the result is bit-identical to ``greedy_spectrum``
    (property-tested on randomized grids). With ``k < K`` decisions are
    heuristic; the scale benchmark prices the quality gap."""
    C = ncfg.n_subcarriers if C is None else C
    K = len(devices)
    assert C >= K, "need at least one subcarrier per device"
    x = np.ones(K, dtype=np.int64)
    pb = PartitionBatch(v, net, ncfg, prof, B, L, [K],
                        np.asarray(devices)[None, :])
    cur = float(pb.latencies(x[None, :])[0])
    if C == K:
        # exactly one subcarrier per device is the only feasible point
        return x, cur
    k0 = min(int(k), K)
    assert k0 >= 1, "k must be >= 1"
    eye = np.eye(K, dtype=np.int64)
    for _ in range(C - K):
        if k0 < K:
            scores = pb.device_scores(x[None, :])[0]
            # ascending candidate order preserves the first-index
            # tie-break within the pruned set
            sel = np.sort(np.argpartition(-scores, k0 - 1)[:k0])
        else:
            sel = np.arange(K)
        lats = pb.latencies(x[None, :] + eye[sel])
        b = int(np.argmin(lats))
        x[sel[b]] += 1
        cur = float(lats[b])
    return x, cur


def brute_force_spectrum(v, devices, net, ncfg, prof, B, L,
                         C: Optional[int] = None):
    """Exhaustive optimum for tiny instances (tests)."""
    C = ncfg.n_subcarriers if C is None else C
    K = len(devices)
    best = (None, math.inf)

    def rec(prefix, remaining, slots):
        nonlocal best
        if slots == 1:
            x = np.array(prefix + [remaining])
            lat = cluster_latency(v, devices, x, net, ncfg, prof, B, L)
            if lat < best[1]:
                best = (x, lat)
            return
        for c in range(1, remaining - (slots - 1) + 1):
            rec(prefix + [c], remaining - c, slots - 1)

    rec([], C, K)
    return best


# --------------------------------------------------------------------------
# Alg. 4 — Gibbs-sampling joint clustering + spectrum allocation
# --------------------------------------------------------------------------

def _round_latency_cached(v, clusters, net, ncfg, prof, B, L, cache,
                          spectrum_fn=None):
    spectrum_fn = spectrum_fn or greedy_spectrum
    total = 0.0
    xs = []
    for ds in clusters:
        key = tuple(sorted(ds))
        if key not in cache:
            cache[key] = spectrum_fn(v, list(key), net, ncfg, prof, B, L)
        x, lat = cache[key]
        # the cached allocation is aligned with the sorted key; reorder it
        # to the cluster's own device order so (clusters, xs) stay paired
        rank = {d: i for i, d in enumerate(key)}
        xs.append(np.asarray(x)[[rank[d] for d in ds]])
        total += lat
    return total, xs


def gibbs_clustering(v: int, net: NetworkState, ncfg: NetworkCfg,
                     prof: CutProfile, B: int, L: int, n_clusters: int,
                     cluster_size: int, iters: int = 1000,
                     delta: float = 1e-4, seed: int = 0,
                     track: bool = False, sizes: Optional[Sequence[int]] = None,
                     spectrum_fn=None, draws=None):
    """Alg. 4: random swap proposals accepted w.p. 1/(1+exp((new-old)/delta)).

    ``sizes`` (optional) partitions the N devices into clusters of the
    given (possibly unequal) sizes instead of ``n_clusters`` equal chunks
    of ``cluster_size`` — needed under churn, where N is not always M*K.
    ``spectrum_fn`` swaps in an alternative Alg. 3 implementation (e.g.
    the vectorized ``repro.sim.batched.greedy_spectrum_batched``).

    ``draws = (init_key, prop_u)`` replaces the internal RNG with
    pre-drawn randomness so an external (e.g. in-jit) mirror can share
    the exact trajectory: ``init_key`` (N,) floats whose stable argsort
    is the initial device ordering, and ``prop_u`` (iters, 5) uniforms
    mapped per iteration to (cluster m, other cluster mp, member i,
    member j, Metropolis accept) by the fixed rule below — ``iters`` is
    then ``len(prop_u)``. The default ``seed`` stream is unchanged.

    Returns (clusters, xs, latency[, history])."""
    N = len(net.f)
    rng = streams.gibbs_rng(seed)
    if draws is not None:
        init_key, prop_u = draws
        prop_u = np.asarray(prop_u, dtype=np.float64)
        iters = prop_u.shape[0]
        order = np.argsort(np.asarray(init_key, dtype=np.float64),
                           kind="stable")
    else:
        order = rng.permutation(N)
    if sizes is not None:
        assert sum(sizes) == N, "cluster sizes must partition the devices"
        n_clusters = len(sizes)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        clusters = [list(order[bounds[m]:bounds[m + 1]])
                    for m in range(n_clusters)]
    else:
        clusters = [list(order[m * cluster_size:(m + 1) * cluster_size])
                    for m in range(n_clusters)]
    cache: dict = {}
    cur, xs = _round_latency_cached(v, clusters, net, ncfg, prof, B, L, cache,
                                    spectrum_fn)
    best = (cur, [list(c) for c in clusters], [x.copy() for x in xs])
    hist = [cur]
    if n_clusters < 2:
        iters = 0          # nothing to swap
    for it in range(iters):
        if draws is not None:
            # fixed uniform->index mapping, shared with the in-jit mirror
            # (truncation of u * n is exact for u in [0, 1); the min()
            # guards the measure-zero u == 1.0 edge)
            u = prop_u[it]
            m = min(int(u[0] * n_clusters), n_clusters - 1)
            mp = min(int(u[1] * (n_clusters - 1)), n_clusters - 2)
            mp += mp >= m
            i = min(int(u[2] * len(clusters[m])), len(clusters[m]) - 1)
            j = min(int(u[3] * len(clusters[mp])), len(clusters[mp]) - 1)
        else:
            m, mp = rng.choice(n_clusters, size=2, replace=False)
            i = rng.integers(len(clusters[m]))
            j = rng.integers(len(clusters[mp]))
        cand = [list(c) for c in clusters]
        cand[m][i], cand[mp][j] = cand[mp][j], cand[m][i]
        new, new_xs = _round_latency_cached(v, cand, net, ncfg, prof, B, L,
                                            cache, spectrum_fn)
        eps = 1.0 / (1.0 + math.exp(min((new - cur) / max(delta, 1e-12),
                                        700.0)))
        accept_u = rng.random() if draws is None else float(prop_u[it][4])
        if accept_u < eps:
            clusters, cur, xs = cand, new, new_xs
        if cur < best[0]:
            best = (cur, [list(c) for c in clusters], [x.copy() for x in xs])
        if track:
            hist.append(cur)
    lat, cl, xs = best
    if track:
        return cl, xs, lat, hist
    return cl, xs, lat


def _uniform_xs(clusters, ncfg):
    """Benchmark schemes don't optimize spectrum: equal split (paper's
    baselines lack the joint spectrum allocation). Uses the shared
    ``equal_split_x`` helper so every cluster's allocation sums to exactly
    its C-subcarrier budget — the old ``max(C//K, 1)`` per device exceeded
    the budget whenever K > C and silently wasted the C mod K remainder
    otherwise, handing the baselines infeasible (or pessimised) spectrum."""
    from repro_torch.core.latency import equal_split_x
    return [equal_split_x(len(c), ncfg.n_subcarriers) for c in clusters]


def heuristic_clustering(v, net, ncfg, prof, B, L, n_clusters, cluster_size,
                         optimize_spectrum: bool = False):
    """Benchmark: group devices with similar compute capability."""
    from repro_torch.core.latency import round_latency
    order = np.argsort(net.f)
    clusters = [list(order[m * cluster_size:(m + 1) * cluster_size])
                for m in range(n_clusters)]
    if optimize_spectrum:
        lat, xs = _round_latency_cached(v, clusters, net, ncfg, prof, B, L,
                                        {})
    else:
        xs = _uniform_xs(clusters, ncfg)
        lat = round_latency(v, clusters, xs, net, ncfg, prof, B, L)
    return clusters, xs, lat


def random_clustering(v, net, ncfg, prof, B, L, n_clusters, cluster_size,
                      seed=0, optimize_spectrum: bool = False):
    from repro_torch.core.latency import round_latency
    rng = streams.layout_rng(seed)
    order = rng.permutation(len(net.f))
    clusters = [list(order[m * cluster_size:(m + 1) * cluster_size])
                for m in range(n_clusters)]
    if optimize_spectrum:
        lat, xs = _round_latency_cached(v, clusters, net, ncfg, prof, B, L,
                                        {})
    else:
        xs = _uniform_xs(clusters, ncfg)
        lat = round_latency(v, clusters, xs, net, ncfg, prof, B, L)
    return clusters, xs, lat


# --------------------------------------------------------------------------
# population scale — coarse (compute, channel) bucketing
# --------------------------------------------------------------------------

def bucket_devices(net: NetworkState, n_buckets: int) -> List[np.ndarray]:
    """Coarse-bucket N devices by joint (compute, channel) quantiles for
    hierarchical two-level clustering: rank every device by f and by
    rate, sort by the rank sum (stable, so ties break on device id), and
    chop the order into ``n_buckets`` balanced contiguous chunks —
    devices in a bucket occupy adjacent quantiles of both resources, so
    within-bucket Gibbs swaps trade near-peers (the bucket-then-solve
    decomposition of heterogeneous-edge PSL, arXiv:2403.15815).

    ``n_buckets == 1`` returns the identity bucket ``[arange(N)]``, which
    makes the hierarchical planner collapse to the flat one bit-exactly
    (``sim.batched.hierarchical_gibbs_clustering`` relies on this)."""
    N = len(net.f)
    n_buckets = max(1, min(int(n_buckets), N))
    if n_buckets == 1:
        return [np.arange(N)]
    rf = np.empty(N, dtype=np.int64)
    rf[np.argsort(net.f, kind="stable")] = np.arange(N)
    rr = np.empty(N, dtype=np.int64)
    rr[np.argsort(net.rate, kind="stable")] = np.arange(N)
    order = np.argsort(rf + rr, kind="stable")
    base, rem = divmod(N, n_buckets)
    sizes = np.full(n_buckets, base, dtype=np.int64) + \
        (np.arange(n_buckets) < rem)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [order[bounds[b]:bounds[b + 1]] for b in range(n_buckets)]


# --------------------------------------------------------------------------
# Alg. 2 — SAA cut-layer selection
# --------------------------------------------------------------------------

def saa_cut_selection(prof: CutProfile, ncfg: NetworkCfg, B: int, L: int,
                      n_clusters: int, cluster_size: int, n_samples: int = 8,
                      gibbs_iters: int = 200, seed: int = 0,
                      cuts: Optional[Sequence[int]] = None,
                      means_override: Optional[Tuple[np.ndarray, np.ndarray]]
                      = None, sizes: Optional[Sequence[int]] = None,
                      spectrum_fn=None) -> Tuple[int, np.ndarray]:
    """Draw J network samples; for each cut layer v evaluate the mean
    per-round latency under Alg. 4 decisions; return argmin and the
    per-cut mean latencies.

    Common random numbers (CRN): sample j's Gibbs run is seeded
    ``seed + j`` for *every* cut — deliberately, not a bug. Reusing the
    same clustering trajectories across cuts couples the per-cut mean
    estimates, so their differences (what the argmin sees) have much lower
    variance than with independent seeds. The vectorized
    ``repro.sim.batched.saa_cut_selection_batched`` reproduces exactly
    this coupling (its (cut, j, chain 0) replicas share the
    ``default_rng(seed + j)`` stream) and the planner equivalence suite
    asserts bit-identical ``(v_star, means)`` at ``chains=1``.

    ``means_override=(mu_f, mu_snr)`` samples around externally tracked
    device means (the dynamic simulator's current estimate) instead of
    drawing fresh means from ``ncfg``."""
    if means_override is not None:
        mu_f, mu_snr = means_override
    else:
        mu_f, mu_snr = device_means(ncfg, seed)
    rng = streams.saa_network_rng(seed)
    nets = [sample_network(ncfg, mu_f, mu_snr, rng) for _ in range(n_samples)]
    cuts = list(cuts) if cuts is not None else list(range(1, prof.n_cuts + 1))
    means = np.zeros(len(cuts))
    for ci, v in enumerate(cuts):
        tot = 0.0
        for j, net in enumerate(nets):
            _, _, lat = gibbs_clustering(v, net, ncfg, prof, B, L,
                                         n_clusters, cluster_size,
                                         iters=gibbs_iters, seed=seed + j,
                                         sizes=sizes, spectrum_fn=spectrum_fn)
            tot += lat
        means[ci] = tot / n_samples
    v_star = cuts[int(np.argmin(means))]
    return v_star, means
