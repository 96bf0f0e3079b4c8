"""Online two-timescale resource controller (paper §VII, made dynamic);
the port's copy of ``repro.sim.controller`` (NumPy, decision-identical).

Large timescale (every ``SimCfg.epoch_len`` slots): re-run SAA cut-layer
selection (Alg. 2) around the *currently tracked* device means — churn
changes the population, so the optimal cut drifts over time.

Small timescale (every slot): re-cluster + re-allocate spectrum with
Gibbs + greedy (Algs. 3/4) on the current channel/compute snapshot. Under
churn N is rarely M*K, so clusters are balanced to at most
``cluster_size`` devices each.

Stale-decision fallback: when devices vanish *mid-round* (after the slot
plan was made), ``repair`` drops them from their clusters and re-runs only
the per-cluster spectrum allocation (Alg. 3) for the affected clusters,
instead of a full (expensive) re-clustering — the plan is marked
``stale`` so traces record that the executed decision differs from the
optimizer output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import streams
from repro_torch.configs.base import SimCfg
from repro_torch.core import resource as rs
from repro_torch.core.channel import NetworkCfg, NetworkState
from repro_torch.core.latency import CutProfile, cluster_latency
# balanced_sizes is defined once, in sim.batched, and re-exported here
from repro_torch.sim.batched import (balanced_sizes,  # noqa: F401
                                     gibbs_clustering_multichain,
                                     greedy_spectrum_batched,
                                     hierarchical_gibbs_clustering,
                                     saa_cut_selection_batched)


@dataclass
class Plan:
    """One slot's executed resource-management decision."""
    v: int
    clusters: List[List[int]]        # local indices into the slot snapshot
    ids: np.ndarray                  # local index -> global device id
    xs: List[np.ndarray]             # subcarriers per device, per cluster
    latency: float                   # predicted round latency (eq. 25)
    stale: bool = False              # True after a mid-round repair

    def global_clusters(self) -> List[List[int]]:
        return [[int(self.ids[i]) for i in c] for c in self.clusters]


class TwoTimescaleController:
    def __init__(self, prof: CutProfile, ncfg: NetworkCfg, B: int, L: int,
                 scfg: SimCfg, spectrum_fn=greedy_spectrum_batched):
        self.prof, self.ncfg = prof, ncfg
        self.B, self.L = B, L
        self.scfg = scfg
        self.spectrum_fn = spectrum_fn
        self.v: Optional[int] = None

    def _ncfg_for(self, n: int) -> NetworkCfg:
        return self.ncfg.replace(n_devices=n)

    # -- large timescale (Alg. 2) ---------------------------------------------

    def select_cut(self, mu_f: np.ndarray, mu_snr: np.ndarray, slot: int,
                   draws=None) -> Tuple[int, np.ndarray]:
        """SAA cut selection around the current population means.

        Runs the replicated ``saa_cut_selection_batched`` — the whole
        (cut x sample x chain) grid in lockstep, ``scfg.gibbs_chains``
        chains per cell — which at ``gibbs_chains=1`` is bit-identical to
        the looped Alg. 2. A custom ``spectrum_fn`` falls back to the
        looped path (the replicated evaluator hard-codes Alg. 3).

        ``draws`` switches the whole SAA evaluation onto pre-drawn
        randomness (the episode-fleet oracle contract):
        ``draws["eta"]`` (J, 2, n) standard normals become the J sampled
        networks (``f = max(mu_f + f_sigma * eta_f, 1e7)``, snr likewise,
        the ``sample_network`` rule), and ``draws["gibbs"][j][c]`` is the
        ``(init_key, prop_u)`` pair for sample j, chain c — shared across
        cuts, preserving the CRN coupling of the seeded path."""
        n = len(mu_f)
        sizes = balanced_sizes(n, self.scfg.cluster_size)
        if draws is not None:
            v, means = self._select_cut_draws(mu_f, mu_snr, sizes, draws)
            self.v = v
            return v, means
        kw = dict(
            n_clusters=len(sizes), cluster_size=max(sizes),
            n_samples=self.scfg.saa_samples,
            gibbs_iters=self.scfg.saa_gibbs_iters,
            # offset the SAA stream away from NetworkProcess's
            # default_rng(dcfg.seed + 1): with the usual scfg.seed ==
            # dcfg.seed, an unoffset slot-0 call would draw a "sample"
            # bit-identical to the realized network — a clairvoyance leak
            seed=self.scfg.seed + 7919 * slot + 104_729,
            cuts=self.scfg.cuts, means_override=(mu_f, mu_snr),
            sizes=sizes)
        if self.spectrum_fn is greedy_spectrum_batched:
            v, means = saa_cut_selection_batched(
                self.prof, self._ncfg_for(n), self.B, self.L,
                chains=max(1, self.scfg.gibbs_chains), **kw)
        else:
            v, means = rs.saa_cut_selection(
                self.prof, self._ncfg_for(n), self.B, self.L,
                spectrum_fn=self.spectrum_fn, **kw)
        self.v = v
        return v, means

    def _select_cut_draws(self, mu_f, mu_snr, sizes, draws
                          ) -> Tuple[int, np.ndarray]:
        """Alg. 2 on pre-drawn randomness (see ``select_cut``): J nets
        from the eta normals, best-of-chains per (cut, sample) cell,
        left-to-right sample accumulation — the rules the in-jit
        episode-fleet SAA reproduces term by term."""
        n = len(mu_f)
        ncfg = self._ncfg_for(n)
        eta = np.asarray(draws["eta"], dtype=np.float64)
        gibbs = draws["gibbs"]                   # [sample][chain]
        cuts = (list(self.scfg.cuts) if self.scfg.cuts is not None
                else list(range(1, self.prof.n_cuts + 1)))
        nets = []
        for j in range(eta.shape[0]):
            f = np.maximum(mu_f + ncfg.f_sigma * eta[j, 0], 1e7)
            snr_db = mu_snr + ncfg.snr_sigma_db * eta[j, 1]
            rate = ncfg.subcarrier_bw * np.log2(1.0 + 10.0 ** (snr_db / 10.0))
            nets.append(NetworkState(f=f, rate=rate))
        means = np.zeros(len(cuts))
        for ci, v in enumerate(cuts):
            tot = 0.0
            for j, net in enumerate(nets):
                best = min(
                    rs.gibbs_clustering(
                        v, net, ncfg, self.prof, self.B, self.L,
                        n_clusters=len(sizes), cluster_size=max(sizes),
                        sizes=sizes, draws=d,
                        spectrum_fn=greedy_spectrum_batched)[2]
                    for d in gibbs[j])
                tot += best
            means[ci] = tot / len(nets)
        return cuts[int(np.argmin(means))], means

    # -- small timescale (Algs. 3/4) ------------------------------------------

    def plan_slot(self, net: NetworkState, ids: np.ndarray, slot: int,
                  draws=None) -> Plan:
        """One slot's Gibbs + greedy plan (Algs. 3/4) over the snapshot.

        ``draws`` (optional) is a list over chains of ``(init_key,
        prop_u)`` pre-drawn randomness pairs (see
        ``core.resource.gibbs_clustering``); the plan is then the
        best-of-chains on those shared draws — the episode-fleet oracle
        path, bypassing the seeded streams entirely."""
        assert self.v is not None, "select_cut must run before plan_slot"
        n = len(ids)
        sizes = balanced_sizes(n, self.scfg.cluster_size)
        if draws is not None:
            results = [rs.gibbs_clustering(
                self.v, net, self._ncfg_for(n), self.prof, self.B, self.L,
                n_clusters=len(sizes), cluster_size=max(sizes),
                sizes=sizes, draws=d, spectrum_fn=greedy_spectrum_batched)
                for d in draws]
            clusters, xs, lat = results[int(np.argmin(
                [r[2] for r in results]))]
            return Plan(v=self.v, clusters=[list(c) for c in clusters],
                        ids=np.asarray(ids), xs=[np.asarray(x) for x in xs],
                        latency=float(lat))
        # distinct namespace from both the NetworkProcess streams and
        # select_cut's SAA stream (see the offset comment there)
        seed = self.scfg.seed + slot + 53_639
        chains = max(1, self.scfg.gibbs_chains)
        if (self.scfg.plan_mode == "bucketed"
                and self.spectrum_fn is greedy_spectrum_batched):
            # population scale: per-bucket lockstep Gibbs stitched over
            # coarse (compute, channel) buckets. With n <= bucket_size
            # there is one bucket and the plan is bit-identical to the
            # flat multichain plan below (tested)
            clusters, xs, lat = hierarchical_gibbs_clustering(
                self.v, net, self._ncfg_for(n), self.prof, self.B, self.L,
                self.scfg.cluster_size, iters=self.scfg.gibbs_iters,
                seed=seed, chains=chains,
                bucket_size=self.scfg.bucket_size,
                spectrum_topk=self.scfg.spectrum_topk)
        elif chains > 1 and self.spectrum_fn is greedy_spectrum_batched:
            # best-of-R lockstep chains; chain 0 is the single-chain
            # stream, so this only ever improves on the chains=1 plan
            clusters, xs, lat = gibbs_clustering_multichain(
                self.v, net, self._ncfg_for(n), self.prof, self.B, self.L,
                n_clusters=len(sizes), cluster_size=max(sizes),
                iters=self.scfg.gibbs_iters, seed=seed, chains=chains,
                sizes=sizes)
        else:
            # best-of-R in the custom-spectrum_fn fallback too: chain 0
            # draws from default_rng(seed) — bit-identical to the old
            # single-chain call — and chain c > 0 from
            # default_rng((seed, c)), the documented stream layout, so
            # best-of-R latency is monotone non-increasing in `chains`
            results = [rs.gibbs_clustering(
                self.v, net, self._ncfg_for(n), self.prof, self.B, self.L,
                n_clusters=len(sizes), cluster_size=max(sizes),
                iters=self.scfg.gibbs_iters,
                seed=streams.chain_key(seed, c),
                sizes=sizes, spectrum_fn=self.spectrum_fn)
                for c in range(chains)]
            clusters, xs, lat = results[int(np.argmin(
                [r[2] for r in results]))]
        return Plan(v=self.v, clusters=[list(c) for c in clusters],
                    ids=np.asarray(ids), xs=[np.asarray(x) for x in xs],
                    latency=float(lat))

    # -- stale-decision fallback ----------------------------------------------

    def repair(self, plan: Plan, net: NetworkState,
               departed_global: Sequence[int]) -> Plan:
        """Remove departed devices from a slot plan without re-clustering.

        Affected clusters get a fresh Alg. 3 run over their survivors;
        untouched clusters keep their (now slightly stale) allocation.
        Clusters that lose all members are dropped."""
        departed = set(int(g) for g in departed_global)
        gid = plan.ids
        clusters: List[List[int]] = []
        xs: List[np.ndarray] = []
        latency = 0.0
        for c, x in zip(plan.clusters, plan.xs):
            keep = [i for i in c if int(gid[i]) not in departed]
            if not keep:
                continue
            if len(keep) == len(c):
                clusters.append(list(c))
                xs.append(np.asarray(x))
                lat = cluster_latency(plan.v, c, x, net,
                                      self._ncfg_for(len(gid)),
                                      self.prof, self.B, self.L)
                latency += lat
            else:
                x2, lat = self.spectrum_fn(plan.v, keep, net,
                                           self._ncfg_for(len(gid)),
                                           self.prof, self.B, self.L)
                clusters.append(keep)
                xs.append(x2)
                latency += lat
        return Plan(v=plan.v, clusters=clusters, ids=gid, xs=xs,
                    latency=float(latency), stale=True)
