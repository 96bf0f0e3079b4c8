"""Vectorized + replicated candidate evaluation for Algs. 2/3/4 (the
port's copy of ``repro.sim.batched``: NumPy, decision-identical to it).

The looped implementations in ``core.resource`` call the scalar
``cluster_latency`` once per candidate, each call re-deriving the
cut-dependent constants. ``core.latency.BatchedClusterEvaluator``
(re-exported here) hoists everything x-independent and scores whole
(P, K) candidate batches with a handful of numpy broadcasts — with a
bit-exactness contract to the scalar path, so the greedy/Gibbs
*decisions* built on it below match the looped baselines exactly.

On top of that sits the *replicated planner layer*
(``core.latency.PartitionBatch``): R full M-cluster partitions — each
replica optionally under its own cut layer and network draw — are scored
in a handful of broadcasts, which turns

  * ``gibbs_clustering_multichain``  — R lockstep Gibbs chains (Alg. 4)
    with independent per-chain RNG streams, returning best-of-R, and
  * ``saa_cut_selection_batched``    — Alg. 2 with the whole
    (cut x network-sample x chain) grid run as one lockstep replica set

into batched numpy instead of nested Python loops.

Per-chain RNG-stream layout (the bit-exactness contract): chain 0 draws
from ``np.random.default_rng(seed)`` — *exactly* the single-chain stream
of ``core.resource.gibbs_clustering(seed=seed)`` — and chain c > 0 draws
from ``np.random.default_rng((seed, c))``. Streams are prefix-stable in
the chain count, so best-of-R latency is monotone non-increasing in R,
and chain 0 reproduces the looped trajectory (initial permutation, swap
proposals, Metropolis accepts, history) bit-for-bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import streams
from repro_torch.core import resource as rs
from repro_torch.core.channel import NetworkCfg, NetworkState
from repro_torch.core.latency import (BatchedClusterEvaluator, CutProfile,
                                      PartitionBatch)

__all__ = ["BatchedClusterEvaluator", "PartitionBatch",
           "greedy_spectrum_batched", "gibbs_clustering_batched",
           "saa_cut_selection_batched", "gibbs_clustering_multichain",
           "MultiChainResult", "hierarchical_gibbs_clustering",
           "HierarchicalResult"]


def balanced_sizes(n: int, k: int) -> List[int]:
    """Partition n devices into ceil(n/k) clusters of near-equal size
    (the reference keeps it in ``sim.controller``, which re-exports this
    one)."""
    if n <= 0:
        return []
    m = max(1, -(-n // k))
    base, extra = divmod(n, m)
    return [base + (1 if i < extra else 0) for i in range(m)]


def greedy_spectrum_batched(v: int, devices: Sequence[int],
                            net: NetworkState, ncfg: NetworkCfg,
                            prof: CutProfile, B: int, L: int,
                            C: Optional[int] = None
                            ) -> Tuple[np.ndarray, float]:
    """Drop-in replacement for ``core.resource.greedy_spectrum``: identical
    decisions (bit-identical candidate latencies, same argmin tie-breaks),
    but each greedy step scores all K candidates in one broadcast instead
    of K scalar ``cluster_latency`` calls."""
    C = ncfg.n_subcarriers if C is None else C
    K = len(devices)
    assert C >= K, "need at least one subcarrier per device"
    ev = BatchedClusterEvaluator(v, devices, net, ncfg, prof, B, L)
    x = np.ones(K, dtype=np.int64)
    cur = float(ev.latencies(x)[0])
    if C == K:
        return x, cur
    eye = np.eye(K, dtype=np.int64)
    for _ in range(C - K):
        cands = ev.latencies(x[None, :] + eye)
        best_k = int(np.argmin(cands))
        x[best_k] += 1
        cur = float(cands[best_k])
    return x, cur


def gibbs_clustering_batched(*args, **kw):
    """Alg. 4 with the vectorized Alg. 3 inner loop — same RNG stream and
    same accepted swaps as ``core.resource.gibbs_clustering``."""
    kw.setdefault("spectrum_fn", greedy_spectrum_batched)
    return rs.gibbs_clustering(*args, **kw)


# --------------------------------------------------------------------------
# Replicated planner: lockstep Gibbs chains over PartitionBatch
# --------------------------------------------------------------------------

def _chain_rng(seed: int, chain: int) -> np.random.Generator:
    """Per-chain RNG streams (see module docstring): chain 0 is
    ``default_rng(seed)`` — the single-chain stream — chain c > 0 is
    ``default_rng((seed, c))``. Prefix-stable in the chain count.
    Registered as the `chain` stream in ``repro_torch.streams``."""
    return streams.chain_rng(seed, chain)


def _greedy_group(tasks, net: NetworkState, ncfg: NetworkCfg,
                  prof: CutProfile, B: int, L: int, topk: int = 0):
    """Alg. 3 greedy run in lockstep for G same-size clusters.

    ``tasks``: list of (v, net_row, sorted device tuple) with equal
    cluster size K. Each of the C-K greedy steps scores all G*K candidate
    allocations through one ``PartitionBatch`` broadcast; candidate
    values (and therefore argmin tie-breaks) are bit-identical to the
    scalar ``core.resource.greedy_spectrum``. Returns [(x, lat)] aligned
    with the sorted keys.

    ``topk`` > 0 prunes each step's candidates to the min(topk, K)
    largest-``device_scores`` devices per cluster (ascending index order
    inside the pruned set), as ``core.resource.greedy_spectrum_topk``;
    at ``topk >= K`` the candidate batch — and every decision — is
    bit-identical to the unpruned path."""
    G, K = len(tasks), len(tasks[0][2])
    C = ncfg.n_subcarriers
    assert C >= K, "need at least one subcarrier per device"
    vs = np.array([t[0] for t in tasks], dtype=np.int64)
    rows = np.array([t[1] for t in tasks], dtype=np.int64)
    dev = np.array([t[2] for t in tasks], dtype=np.int64)
    pb0 = PartitionBatch(vs, net, ncfg, prof, B, L, [K], dev, net_rows=rows)
    X = np.ones((G, K), dtype=np.int64)
    cur = pb0.latencies(X)
    if C == K:
        return [(X[g].copy(), float(cur[g])) for g in range(G)]
    k0 = min(int(topk), K) if topk else K
    pb = PartitionBatch(np.repeat(vs, k0), net, ncfg, prof, B, L, [K],
                        np.repeat(dev, k0, axis=0),
                        net_rows=np.repeat(rows, k0))
    gi = np.arange(G)
    for _ in range(C - K):
        if k0 < K:
            scores = pb0.device_scores(X)
            sel = np.sort(np.argpartition(-scores, k0 - 1, axis=1)[:, :k0],
                          axis=1)
        else:
            sel = np.broadcast_to(np.arange(K), (G, K))
        cand = np.repeat(X, k0, axis=0)
        cand[np.arange(G * k0), sel.reshape(-1)] += 1
        lats = pb.latencies(cand).reshape(G, k0)
        b = np.argmin(lats, axis=1)
        X[gi, sel[gi, b]] += 1
        cur = lats[gi, b]
    return [(X[g].copy(), float(cur[g])) for g in range(G)]


def _fill_cache(cache: Dict, triples, net, ncfg, prof, B, L,
                topk: int = 0) -> None:
    """Run lockstep greedy for every uncached (v, net_row, cluster-key)
    triple, grouped by cluster size."""
    todo = [t for t in dict.fromkeys(triples) if t not in cache]
    by_k: Dict[int, list] = {}
    for t in todo:
        by_k.setdefault(len(t[2]), []).append(t)
    for tasks in by_k.values():
        for t, res in zip(tasks, _greedy_group(tasks, net, ncfg, prof, B, L,
                                               topk=topk)):
            cache[t] = res


def _aligned_x(cache, v: int, row: int, seg: np.ndarray) -> np.ndarray:
    """Cached allocation for ``seg``'s cluster, reordered from the sorted
    cache key to the cluster's own device order (same pairing rule as
    ``core.resource._round_latency_cached``)."""
    key = tuple(sorted(seg.tolist()))
    x_sorted, _ = cache[(v, row, key)]
    rank = {d: i for i, d in enumerate(key)}
    return x_sorted[[rank[int(d)] for d in seg]]


def _lockstep_gibbs(vs: np.ndarray, net: NetworkState, rows: np.ndarray,
                    rngs: List[np.random.Generator], ncfg: NetworkCfg,
                    prof: CutProfile, B: int, L: int, n_clusters: int,
                    cluster_size: int, iters: int, delta: float,
                    sizes: Optional[Sequence[int]], track: bool,
                    topk: int = 0):
    """R lockstep Gibbs chains (Alg. 4); replica r runs under cut
    ``vs[r]``, network draw ``net.f[rows[r]]``, RNG ``rngs[r]``.

    All chains share one Alg. 3 cache keyed (v, net_row, cluster); per
    iteration the <= 2R affected clusters are filled by ``_greedy_group``
    (the dominant cost, batched through ``PartitionBatch``) and each
    candidate partition's total is the left-to-right sum of its cached
    per-cluster latencies — the same accumulation as the looped
    ``_round_latency_cached``, so each replica's trajectory is
    bit-identical to ``core.resource.gibbs_clustering(v, net_j,
    seed-stream)``.

    Returns (best_lats (R,), [(clusters, xs, lat)] per replica, hists)."""
    R = len(rngs)
    n_dev = net.f.shape[1]
    if sizes is not None:
        assert sum(sizes) == n_dev, "cluster sizes must partition devices"
        sizes = [int(s) for s in sizes]
        n_clusters = len(sizes)
    else:
        # mirror the looped path's order[m*K:(m+1)*K] slicing, which
        # needs at least M*K devices to fill every cluster
        assert n_clusters * cluster_size <= n_dev, \
            "pass `sizes` when N < n_clusters * cluster_size"
        sizes = [cluster_size] * n_clusters
    M = n_clusters
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    N = int(bounds[-1])
    vs = np.asarray(vs, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)

    # initial partitions: same permutation slicing as the looped path
    D = np.empty((R, N), dtype=np.int64)
    for r, rng in enumerate(rngs):
        D[r] = rng.permutation(n_dev)[:N]

    cache: Dict = {}
    segs = [(int(bounds[m]), int(bounds[m + 1])) for m in range(M)]

    def seg_triples(dmat, rsel):
        return [(int(vs[r]), int(rows[r]), tuple(sorted(dmat[r, s:e].tolist())))
                for r in rsel for (s, e) in segs]

    def _total(row):
        # left-to-right float accumulation, exactly _round_latency_cached
        total = 0.0
        for lat in row:
            total += lat
        return total

    _fill_cache(cache, seg_triples(D, range(R)), net, ncfg, prof, B, L,
                topk=topk)
    X = np.empty((R, N), dtype=np.int64)
    clats = []                       # per-replica cached cluster latencies
    for r in range(R):
        row = []
        for s, e in segs:
            key = tuple(sorted(D[r, s:e].tolist()))
            X[r, s:e] = _aligned_x(cache, int(vs[r]), int(rows[r]), D[r, s:e])
            row.append(cache[(int(vs[r]), int(rows[r]), key)][1])
        clats.append(row)
    cur = np.array([_total(row) for row in clats])

    best_lat = cur.copy()
    best_D, best_X = D.copy(), X.copy()
    hists = [[float(cur[r])] for r in range(R)] if track else None
    if M < 2:
        iters = 0          # nothing to swap
    dmin = max(delta, 1e-12)
    for _ in range(iters):
        props = []
        for r, rng in enumerate(rngs):
            m, mp = rng.choice(M, size=2, replace=False)
            i = int(rng.integers(sizes[m]))
            j = int(rng.integers(sizes[mp]))
            props.append((r, int(m), int(mp),
                          int(bounds[m]) + i, int(bounds[mp]) + j))
        D_cand, X_cand = D.copy(), X.copy()
        trips = []
        for r, m, mp, p, q in props:
            D_cand[r, p], D_cand[r, q] = D[r, q], D[r, p]
            for mm in (m, mp):
                s, e = segs[mm]
                trips.append((int(vs[r]), int(rows[r]),
                              tuple(sorted(D_cand[r, s:e].tolist()))))
        _fill_cache(cache, trips, net, ncfg, prof, B, L, topk=topk)
        cand_lats = []
        for r, m, mp, p, q in props:
            row = list(clats[r])
            for mm in (m, mp):
                s, e = segs[mm]
                key = tuple(sorted(D_cand[r, s:e].tolist()))
                X_cand[r, s:e] = _aligned_x(cache, int(vs[r]), int(rows[r]),
                                            D_cand[r, s:e])
                row[mm] = cache[(int(vs[r]), int(rows[r]), key)][1]
            cand_lats.append(row)
        for r, rng in enumerate(rngs):
            new = _total(cand_lats[r])
            eps = 1.0 / (1.0 + math.exp(min((new - float(cur[r])) / dmin,
                                            700.0)))
            if rng.random() < eps:
                D[r], X[r], cur[r] = D_cand[r], X_cand[r], new
                clats[r] = cand_lats[r]
            if cur[r] < best_lat[r]:
                best_lat[r] = cur[r]
                best_D[r], best_X[r] = D[r], X[r]
            if track:
                hists[r].append(float(cur[r]))

    results = []
    for r in range(R):
        clusters = [[int(d) for d in best_D[r, s:e]] for s, e in segs]
        xs = [best_X[r, s:e].copy() for s, e in segs]
        results.append((clusters, xs, float(best_lat[r])))
    return best_lat, results, hists


@dataclass
class MultiChainResult:
    """Full output of ``gibbs_clustering_multichain(full=True)``."""
    clusters: List[List[int]]            # best-of-R partition
    xs: List[np.ndarray]                 # its per-cluster allocations
    latency: float                       # its round latency (eq. 25)
    best_chain: int                      # argmin chain index
    chain_latencies: np.ndarray          # (R,) per-chain best latencies
    chain_results: List[Tuple]           # per-chain (clusters, xs, lat)
    hists: Optional[List[List[float]]] = None   # per-chain, when track=True


def gibbs_clustering_multichain(v: int, net: NetworkState, ncfg: NetworkCfg,
                                prof: CutProfile, B: int, L: int,
                                n_clusters: int, cluster_size: int,
                                iters: int = 1000, delta: float = 1e-4,
                                seed: int = 0, chains: int = 1,
                                track: bool = False,
                                sizes: Optional[Sequence[int]] = None,
                                full: bool = False, spectrum_topk: int = 0):
    """Alg. 4 run as ``chains`` lockstep Gibbs replicas, returning the
    best-of-R solution.

    Bit-exactness contract: chain 0 draws from ``default_rng(seed)`` and
    reproduces ``core.resource.gibbs_clustering(..., seed=seed)`` exactly
    — same initial permutation, proposals, candidate latencies (via
    ``PartitionBatch``), Metropolis accepts, and tracked history. Chain
    c > 0 draws from ``default_rng((seed, c))`` (see module docstring),
    so streams are prefix-stable and best-of-R latency is monotone
    non-increasing in ``chains`` — at equal seed the multichain result is
    never worse than the single-chain one.

    Returns ``(clusters, xs, latency)`` of the winning chain, plus the
    per-chain histories when ``track=True`` (a list of R lists; entry 0
    matches the single-chain ``track=True`` history). ``full=True``
    returns a :class:`MultiChainResult` with every chain's best."""
    assert chains >= 1
    snet = NetworkState(f=np.asarray(net.f, float)[None, :],
                        rate=np.asarray(net.rate, float)[None, :])
    vs = np.full(chains, v, dtype=np.int64)
    rows = np.zeros(chains, dtype=np.int64)
    rngs = [_chain_rng(seed, c) for c in range(chains)]
    lats, results, hists = _lockstep_gibbs(
        vs, snet, rows, rngs, ncfg, prof, B, L, n_clusters, cluster_size,
        iters, delta, sizes, track, topk=spectrum_topk)
    b = int(np.argmin(lats))
    clusters, xs, lat = results[b]
    if full:
        return MultiChainResult(clusters, xs, lat, b, np.asarray(lats),
                                results, hists)
    if track:
        return clusters, xs, lat, hists
    return clusters, xs, lat


# --------------------------------------------------------------------------
# Population scale: hierarchical two-level clustering
# --------------------------------------------------------------------------

def _bucket_chain_rng(seed: int, bucket: int, chain: int
                      ) -> np.random.Generator:
    """Per-(bucket, chain) RNG streams: bucket 0 reuses the flat
    ``_chain_rng(seed, c)`` streams — so with a single bucket the
    hierarchical planner replays ``gibbs_clustering_multichain``
    bit-for-bit — and bucket b > 0 draws from
    ``default_rng((seed, 6151, b, c))``, a namespace disjoint from every
    flat-planner stream (6151 is an arbitrary fixed tag).  Registered
    as the `bucket_chain` stream in ``repro_torch.streams``."""
    return streams.bucket_chain_rng(seed, bucket, chain)


@dataclass
class HierarchicalResult:
    """Full output of ``hierarchical_gibbs_clustering(full=True)``."""
    clusters: List[List[int]]            # stitched partition, bucket order
    xs: List[np.ndarray]                 # its per-cluster allocations
    latency: float                       # total round latency (eq. 25)
    buckets: List[np.ndarray]            # global device ids per bucket
    bucket_latencies: np.ndarray         # (n_buckets,) per-bucket bests


def hierarchical_gibbs_clustering(v: int, net: NetworkState,
                                  ncfg: NetworkCfg, prof: CutProfile,
                                  B: int, L: int, cluster_size: int,
                                  iters: int = 1000, delta: float = 1e-4,
                                  seed: int = 0, chains: int = 1,
                                  n_buckets: Optional[int] = None,
                                  bucket_size: Optional[int] = None,
                                  spectrum_topk: int = 0,
                                  full: bool = False):
    """Two-level Alg. 4 for population scale: coarse-bucket the N devices
    by joint (compute, channel) quantiles (``core.resource.
    bucket_devices``), run ``chains`` lockstep Gibbs replicas *within*
    each bucket, and stitch the per-bucket best-of-chains solutions —
    the bucket-then-solve decomposition of heterogeneous-edge PSL
    (arXiv:2403.15815). Plan time scales as O(n_buckets) independent
    bucket solves of bounded size instead of one Gibbs whose per-sweep
    cost grows with N, and clusters never straddle buckets, so every
    Alg. 3 run stays at most ``bucket_size`` wide.

    ``n_buckets`` (or ``bucket_size``, ceil(N / bucket_size) buckets;
    default 320 devices per bucket) sets the coarse level; each bucket is
    chopped into ``balanced_sizes(n_b, cluster_size)`` clusters.
    ``spectrum_topk`` additionally prunes the embedded greedy's argmin
    candidates (``_greedy_group``'s ``topk``). Per-bucket sweeps =
    ``iters``.

    Exactness fallback (tested): with one bucket the bucketing is the
    identity, bucket 0's RNG streams are the flat ``_chain_rng`` ones,
    and the single ``_lockstep_gibbs`` call is argument-identical to
    ``gibbs_clustering_multichain(..., sizes=balanced_sizes(N, K))`` —
    clusters, allocations, and latency are bit-identical.

    Buckets group by size into lockstep ``_lockstep_gibbs`` batches (all
    same-size buckets x chains replicas in one call), so the coarse level
    adds at most two batched solves, not n_buckets Python-loop solves.

    Returns ``(clusters, xs, latency)`` — global device ids, clusters in
    bucket order, total = left-to-right sum of per-bucket bests — or a
    :class:`HierarchicalResult` when ``full=True``."""
    N = len(net.f)
    if n_buckets is None:
        bs = int(bucket_size) if bucket_size else 320
        n_buckets = -(-N // bs)
    buckets = rs.bucket_devices(net, n_buckets)
    chains = max(1, int(chains))
    f_all = np.asarray(net.f, dtype=np.float64)
    r_all = np.asarray(net.rate, dtype=np.float64)

    by_size: Dict[int, List[int]] = {}
    for b, ids in enumerate(buckets):
        by_size.setdefault(len(ids), []).append(b)

    bucket_best: Dict[int, Tuple[List[List[int]], List[np.ndarray], float]] \
        = {}
    for n_b, bsel in by_size.items():
        snet = NetworkState(f=np.stack([f_all[buckets[b]] for b in bsel]),
                            rate=np.stack([r_all[buckets[b]] for b in bsel]))
        G = len(bsel) * chains
        vs = np.full(G, v, dtype=np.int64)
        rows = np.repeat(np.arange(len(bsel), dtype=np.int64), chains)
        rngs = [_bucket_chain_rng(seed, b, c) for b in bsel
                for c in range(chains)]
        sizes = balanced_sizes(n_b, cluster_size)
        lats, results, _ = _lockstep_gibbs(
            vs, snet, rows, rngs, ncfg, prof, B, L, len(sizes),
            max(sizes), iters, delta, sizes, track=False,
            topk=spectrum_topk)
        lats = np.asarray(lats, float).reshape(len(bsel), chains)
        for gb, b in enumerate(bsel):
            best_c = int(np.argmin(lats[gb]))
            cl, xs, lat = results[gb * chains + best_c]
            gid = buckets[b]
            bucket_best[b] = ([[int(gid[i]) for i in c] for c in cl],
                              [np.asarray(x) for x in xs], float(lat))

    clusters: List[List[int]] = []
    xs: List[np.ndarray] = []
    blats = np.empty(len(buckets))
    total = 0.0
    for b in range(len(buckets)):
        cl, bx, lat = bucket_best[b]
        clusters.extend(cl)
        xs.extend(bx)
        blats[b] = lat
        total += lat          # left-to-right, as _round_latency_cached
    if full:
        return HierarchicalResult(clusters, xs, float(total), buckets, blats)
    return clusters, xs, float(total)


def saa_cut_selection_batched(prof: CutProfile, ncfg: NetworkCfg, B: int,
                              L: int, n_clusters: int, cluster_size: int,
                              n_samples: int = 8, gibbs_iters: int = 200,
                              seed: int = 0,
                              cuts: Optional[Sequence[int]] = None,
                              means_override: Optional[Tuple[np.ndarray,
                                                             np.ndarray]]
                              = None, sizes: Optional[Sequence[int]] = None,
                              chains: int = 1, delta: float = 1e-4
                              ) -> Tuple[int, np.ndarray]:
    """Alg. 2 with the whole (cut x network-sample x chain) grid run as one
    set of lockstep Gibbs replicas over ``PartitionBatch`` — no per-cut /
    per-sample Python loop.

    Same ``(v_star, means)`` contract as ``core.resource.saa_cut_selection``:
    identical network draws (one ``default_rng(seed + 1)`` stream), and the
    same common-random-numbers coupling — the replica for (cut v, sample j,
    chain 0) draws from ``default_rng(seed + j)`` exactly like the looped
    ``gibbs_clustering(..., seed=seed + j)`` call, for *every* cut. At
    ``chains=1`` the returned ``v_star`` and per-cut means are bit-identical
    to the looped implementation (the equivalence suite pins this); with
    ``chains > 1`` each (cut, sample) cell takes the best-of-R latency, so
    means can only improve."""
    if means_override is not None:
        mu_f, mu_snr = means_override
    else:
        mu_f, mu_snr = rs.device_means(ncfg, seed)
    rng = streams.saa_network_rng(seed)
    nets = [rs.sample_network(ncfg, mu_f, mu_snr, rng)
            for _ in range(n_samples)]
    cuts = list(cuts) if cuts is not None else list(range(1, prof.n_cuts + 1))
    snet = NetworkState(f=np.stack([n.f for n in nets]),
                        rate=np.stack([n.rate for n in nets]))
    vs, rows, rngs = [], [], []
    for v in cuts:
        for j in range(n_samples):
            for c in range(chains):
                vs.append(v)
                rows.append(j)
                rngs.append(_chain_rng(seed + j, c))
    lats, _, _ = _lockstep_gibbs(
        np.asarray(vs), snet, np.asarray(rows), rngs, ncfg, prof, B, L,
        n_clusters, cluster_size, gibbs_iters, delta, sizes, track=False)
    lats = np.asarray(lats, float).reshape(len(cuts), n_samples, chains)
    means = np.zeros(len(cuts))
    for ci in range(len(cuts)):
        tot = 0.0
        for j in range(n_samples):
            tot += min(float(l) for l in lats[ci, j])    # best-of-chains
        means[ci] = tot / n_samples
    v_star = cuts[int(np.argmin(means))]
    return v_star, means
