"""Episode fleets: E dynamic-network episodes as one batched float64
program (the port of ``repro.sim.fleet``).

Monte-Carlo evaluation of wireless round latency under network dynamics
across seeds / policies / cluster sizes / cut layers (paper §VIII, figs.
7-8) runs as one host loop over slots whose every step is a handful of
float64 tensor operations over the whole episode axis, instead of one
host NumPy loop per episode. The reference expresses the same program
with ``lax.scan`` / ``lax.map`` / ``fori_loop`` / ``lax.cond``; here they
are Python loops with host-static bounds (slots, greedy steps, cluster
tiles, Gibbs sweeps) and a host-int slot index, so nothing in the slot
loop reads a tensor back to the host: acceptance, ``enabled`` and churn
stay tensor masks, and a run syncs the host once, at its end.

Three layers, all float64 (the cost model's contract dtype):

  * a tensor port of ``sim.dynamics.NetworkProcess`` — Gauss-Markov
    AR(1) fading + compute drift with the exact stationary-law-preserving
    innovation scaling, over a FIXED population with an active-mask for
    churn: deterministic per-device depart/arrive slots, stochastic
    Bernoulli departures/arrivals on pre-drawn uniforms with the
    ``min_devices`` floor (decision-identical to
    ``NetworkProcess.sample_departures`` / ``sample_arrivals`` on shared
    draws), and energy depletion with the floor-pinned delayed-depart
    semantics of ``NetworkProcess.consume``;
  * the eq. (15)-(25) tensor cost model of ``core.latency``
    (``_cluster_latency_j`` keeps the operand order of
    ``cluster_latency`` term by term; ``PartitionBatchJ`` wraps it in the
    NumPy ``PartitionBatch`` API);
  * fixed-shape per-slot control — balanced clustering over the active
    devices padded to (M, K) slot masks, with three policies selected
    per episode: equal-split (``core.latency.equal_split_x``), greedy
    Alg. 3 (lockstep steps, same candidate argmin as
    ``core.resource.greedy_spectrum``), and the paper's PROPOSED
    two-timescale controller — Gibbs clustering with the embedded
    greedy (Alg. 4, ``_gibbs_cells``: fixed lockstep sweeps over
    pre-drawn uniforms, best-of-``gibbs_chains``) every slot plus SAA
    cut re-selection (Alg. 2, a (cut x sample x chain) cell batch around
    the tracked means) every ``epoch_len`` slots, with post-departure
    spectrum repair within the slot. The host ``TwoTimescaleController``
    consumes the same pre-drawn uniforms (``draws=`` hooks), so the
    batched arm and the looped host oracle make identical decisions.

Ties and order follow the reference: stable argsorts, first-extreme
``argmin`` / ``argmax``, left-to-right cluster sums, truncating int
casts of non-negative values, floor division of tensors, and
``exp(min(x, 700))``.

The AR(1) innovations are the one deliberate difference: the reference
draws them with threefry (``jax.random.normal`` on ``fold_in`` of its
fleet master key), which torch cannot reproduce; the port draws them
from the registered NumPy stream ``streams.fleet_innovations_rng(seed,
episode seed)``. Parity tests copy the reference runner's innovations
into the port's runner; every other pre-drawn array is bit-equal.

:class:`SimFleetRunner` prices the whole ``SimFleetCfg`` grid in one
call, mirrors every decision in a looped NumPy reference
(``run_reference`` — identical innovations and pre-drawn controller /
churn uniforms, host ``round_latency`` pricing), and can couple a
static-scenario grid to ``CPSL.run_fleet`` for joint latency x accuracy
curves (``train_curves``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, streams
from repro_torch.configs.base import SimFleetCfg
from repro_torch.core import latency as lt
from repro_torch.core.channel import NetworkCfg, NetworkState, device_means
from repro_torch.core.latency import (CutProfile, PartitionBatchJ, _CST_KEYS,
                                      _cluster_latency_j, _cost_terms,
                                      _cost_with, _sum_left_to_right,
                                      equal_split_x)
from repro_torch.sim.controller import balanced_sizes
from repro_torch.sim.dynamics import DynamicsCfg

__all__ = ["PartitionBatchJ", "SimFleetRunner", "fleet_trace_records",
           "recompute_fleet_latencies"]

_F_FLOOR = 1e7                      # compute floor, as NetworkProcess
POLICY_EQUAL, POLICY_GREEDY, POLICY_PROPOSED = 0, 1, 2
LAYOUT_RANK, LAYOUT_COMPUTE = 0, 1
_I32, _I64, _F64 = torch.int32, torch.int64, torch.float64


def _gather(a, idx):
    """``a[e, idx[e, ...]]`` for (E, N) ``a`` and (E, ...) ``idx``."""
    E = idx.shape[0]
    return torch.gather(a, 1, idx.reshape(E, -1)).reshape(idx.shape)


# --------------------------------------------------------------------------
# per-slot control: balanced layout + spectrum policies
# --------------------------------------------------------------------------

def _layout(order, n_active, Ktgt, *, M: int, K: int):
    """Balanced clustering of the first ``n_active[e]`` entries of
    ``order[e]`` into clusters of target size ``Ktgt[e]`` — the mirror of
    ``controller.balanced_sizes`` + consecutive chunking, for every row
    at once. Returns (dev (E, M, K), mask (E, M, K), csize (E, M))."""
    n = n_active[:, None]
    kt = Ktgt[:, None]
    Mreal = torch.where(n > 0, -(-n // kt), 0)       # ceil(n / Ktgt)
    Msafe = Mreal.clamp(min=1)
    base = n // Msafe
    extra = n - base * Msafe
    m_idx = torch.arange(M, device=order.device)[None, :]
    csize = torch.where(m_idx < Mreal, base + (m_idx < extra), 0)
    starts = torch.cumsum(csize, dim=1) - csize
    k_idx = torch.arange(K, device=order.device)
    pos = starts[:, :, None] + k_idx
    mask = k_idx < csize[:, :, None]
    dev = _gather(order, pos.clamp(0, order.shape[1] - 1))
    return torch.where(mask, dev, 0), mask, csize


def _equal_xs(csize, mask, C: int):
    """Per-cluster equal split with remainder distribution — the mirror
    of ``core.latency.equal_split_x`` (padded slots get 1 to keep
    divisions finite; they are masked out of every latency term). The
    remainder goes to the first ``C mod K`` SURVIVORS in slot order — on
    a contiguous plan mask that is slots 0..rem-1, on a gappy
    post-repair mask it matches the host repair's equal split over the
    surviving member list."""
    safe = csize.clamp(min=1)
    base = C // safe
    rem = C - base * safe
    srank = torch.cumsum(mask, dim=-1) - 1           # survivor rank
    xs = base[..., None] + (srank < rem[..., None])
    return torch.where(mask, xs, 1).to(_I32)


def _greedy_xs(cst_b, fd, rd, mask, csize, *, C: int, B: int, L: int,
               f_server_kappa: float, kappa: float, chunk: int = 0):
    """Lockstep greedy Alg. 3 over every (episode, cluster) slot: start
    at one subcarrier per device, then C - K_m gated steps each granting
    one subcarrier to the argmin-latency candidate — candidate values
    and first-min tie-breaks match ``core.resource.greedy_spectrum``
    (per-cluster decisions are independent, so lockstep == sequential).

    ``cst_b``: constants broadcastable against the (E, M, Kc, K)
    candidate tensor. Returns (E, M, K) int32 allocations summing to C
    on every real cluster.

    ``chunk`` > 0 runs the cluster axis in tiles of that many clusters,
    bounding the (E, M, Kc, K) candidate tensor at (E, chunk, Kc, K).
    Per-cluster decisions are independent of the batch they ride in, so
    the allocations are unchanged."""
    E, M, K = fd.shape
    if chunk and chunk < M:
        return torch.cat([
            _greedy_xs(cst_b, fd[:, lo:lo + chunk], rd[:, lo:lo + chunk],
                       mask[:, lo:lo + chunk], csize[:, lo:lo + chunk],
                       C=C, B=B, L=L, f_server_kappa=f_server_kappa,
                       kappa=kappa)
            for lo in range(0, M, chunk)], dim=1)

    eye = torch.eye(K, dtype=_I32, device=fd.device)
    # the allocation-independent terms, once: each greedy step re-prices
    # only the allocation-dependent ones (the same bits as recomputing)
    terms = _cost_terms(cst_b, fd[:, :, None, :], rd[:, :, None, :],
                        mask[:, :, None, :], csize[:, :, None], B=B, L=L,
                        C=C, f_server_kappa=f_server_kappa, kappa=kappa)
    # step i grants a subcarrier on the live clusters with i < C - K_m
    steps = torch.arange(C - 1, device=fd.device)[:, None, None]
    grant = ((steps < C - csize) & (csize > 0)).to(_I32)[..., None]
    X = torch.ones((E, M, K), dtype=_I32, device=fd.device)
    for i in range(C - 1):
        cand = X[:, :, None, :] + eye                        # (E,M,Kc,K)
        D = _cost_with(terms, cand)
        D = torch.where(mask, D, float("inf"))  # only real slots are cands
        best = torch.argmin(D, dim=-1, keepdim=True)         # (E, M, 1)
        X.scatter_add_(-1, best, grant[i])
    return X


# --------------------------------------------------------------------------
# Alg. 4 — lockstep Gibbs cells (the proposed policy's planner)
# --------------------------------------------------------------------------

def _gibbs_cells(cst, fG, rG, activeG, KtgtG, keyG, propG, *, M: int,
                 K: int, C: int, B: int, L: int, f_server_kappa: float,
                 kappa: float, delta: float, chunk: int = 0):
    """G independent Gibbs chains (Alg. 4 with embedded Alg. 3) in
    lockstep — the mirror of ``core.resource.gibbs_clustering`` on
    pre-drawn randomness (its ``draws=`` path), decision-for-decision on
    shared draws.

    Per cell g: ``keyG[g]`` (N,) floats whose stable argsort over the
    active devices is the initial balanced layout, and ``propG[g]``
    (iters, 5) uniforms map per sweep to (cluster m, other cluster mp,
    member i, member j, Metropolis accept) by the exact uniform->index
    rule of the host path. Each sweep re-runs the 2-row greedy on the
    swapped clusters only (the other rows' latencies are carried), as
    the host's cluster-keyed cache does. Cells with fewer than two real
    clusters never accept (the host sets ``iters = 0``).

    ``cst``: per-cell (G,) profile constants. Returns
    (dev, mask, csize, xs, total) of the best-so-far state — mask and
    csize are swap-invariant, so they equal the initial layout's."""
    G, N = fG.shape
    device = fG.device
    g_ar = torch.arange(G, device=device)
    cst3 = {k: v[:, None, None] for k, v in cst.items()}
    cst4 = {k: v[:, None, None, None] for k, v in cst.items()}
    kw = dict(B=B, L=L, C=C, f_server_kappa=f_server_kappa, kappa=kappa)

    n_act = activeG.sum(dim=1)
    order = torch.argsort(torch.where(activeG, keyG, float("inf")), dim=1,
                          stable=True)
    dev, mask, csize = _layout(order, n_act, KtgtG, M=M, K=K)
    fd = _gather(fG, dev)
    rd = _gather(rG, dev)
    xs = _greedy_xs(cst4, fd, rd, mask, csize, chunk=chunk, **kw)
    lat_m = _cluster_latency_j(cst3, fd, rd, xs, mask, csize, **kw)
    cur = _sum_left_to_right(lat_m)

    Mreal = torch.where(n_act > 0, -(-n_act // KtgtG), 0)
    enabled = Mreal >= 2
    dsafe = max(float(delta), 1e-12)
    k_idx = torch.arange(K, device=device)
    m_ar = torch.arange(M, device=device)
    b_tot, b_dev, b_xs = cur, dev, xs
    for it in range(propG.shape[1]):
        u = propG[:, it]                                    # (G, 5)
        # fixed uniform->index mapping (host gibbs_clustering draws path):
        # trunc(u * n) with a min() guard on the u == 1.0 edge
        m = torch.minimum((u[:, 0] * Mreal).to(_I32), Mreal - 1
                          ).clamp(0, M - 1).to(_I64)
        mp = torch.minimum((u[:, 1] * (Mreal - 1)).to(_I32), Mreal - 2
                           ).clamp(0, M - 1)
        mp = (mp + (mp >= m)).clamp(0, M - 1).to(_I64)
        cm, cmp_ = csize[g_ar, m], csize[g_ar, mp]
        i = torch.minimum((u[:, 2] * cm).to(_I32), cm - 1
                          ).clamp(0, K - 1).to(_I64)
        j = torch.minimum((u[:, 3] * cmp_).to(_I32), cmp_ - 1
                          ).clamp(0, K - 1).to(_I64)
        # candidate: swap member i of cluster m with member j of mp
        dm, dmp = dev[g_ar, m], dev[g_ar, mp]               # (G, K)
        vi, vj = dm[g_ar, i], dmp[g_ar, j]
        dm2 = torch.where(k_idx == i[:, None], vj[:, None], dm)
        dmp2 = torch.where(k_idx == j[:, None], vi[:, None], dmp)
        dev2 = torch.stack([dm2, dmp2], dim=1)              # (G, 2, K)
        mask2 = torch.stack([mask[g_ar, m], mask[g_ar, mp]], dim=1)
        cs2 = torch.stack([cm, cmp_], dim=1)
        fd2 = _gather(fG, dev2)
        rd2 = _gather(rG, dev2)
        xs2 = _greedy_xs(cst4, fd2, rd2, mask2, cs2, **kw)
        lat2 = _cluster_latency_j(cst3, fd2, rd2, xs2, mask2, cs2, **kw)
        oh_m = m_ar == m[:, None]                           # (G, M)
        oh_mp = m_ar == mp[:, None]
        lat_new = torch.where(oh_m, lat2[:, 0:1], lat_m)
        lat_new = torch.where(oh_mp, lat2[:, 1:2], lat_new)
        new_tot = _sum_left_to_right(lat_new)
        eps = 1.0 / (1.0 + torch.exp(torch.clamp((new_tot - cur) / dsafe,
                                                 max=700.0)))
        acc = enabled & (u[:, 4] < eps)
        am, amp = oh_m & acc[:, None], oh_mp & acc[:, None]
        um, ump = am[:, :, None], amp[:, :, None]
        dev = torch.where(um, dm2[:, None, :], dev)
        dev = torch.where(ump, dmp2[:, None, :], dev)
        xs = torch.where(um, xs2[:, 0:1, :], xs)
        xs = torch.where(ump, xs2[:, 1:2, :], xs)
        lat_m = torch.where(am, lat2[:, 0:1], lat_m)
        lat_m = torch.where(amp, lat2[:, 1:2], lat_m)
        cur = torch.where(acc, new_tot, cur)
        better = cur < b_tot
        b_tot = torch.where(better, cur, b_tot)
        b_dev = torch.where(better[:, None, None], dev, b_dev)
        b_xs = torch.where(better[:, None, None], xs, b_xs)
    return b_dev, mask, csize, b_xs, b_tot


# --------------------------------------------------------------------------
# the episode fleet program
# --------------------------------------------------------------------------

def _simulate(data, *, B: int, L: int, C: int, M: int, K: int, T: int,
              bw: float, kappa: float, f_server_kappa: float,
              f_sigma: float, snr_sigma: float, rho_f: float,
              rho_snr: float, coef_f: float, coef_s: float,
              p_compute: float, p_tx: float, track_energy: bool,
              greedy_rows: tuple, proposed_rows: tuple = (),
              gibbs_delta: float = 1e-4, p_depart: float = 0.0,
              p_arrive: float = 0.0, min_floor: int = 0,
              epoch_len: int = 1, saa_cuts: tuple = (),
              n_reserve: int = 0, cost_chunk: int = 0):
    """The whole E-episode, T-slot simulation.

    ``data``: one dict of episode tensors on one device — means and
    innovations (E, N) / (T, E, N), grid selectors (E,), the per-cut
    constant table ``cst_full`` {key: (n_cuts,)}, churn schedules, and
    (when the grid needs them) pre-drawn uniforms for Bernoulli churn
    (``u_dep`` (T, E, N), ``u_arr`` (T, E)), the proposed arm's per-slot
    Gibbs draws (``gkey`` (T, P, R, N), ``gprop`` (T, P, R, iters, 5))
    and per-epoch SAA draws (``saa_eta`` (n_ep, P, J, 2, N), ``saa_key``
    (n_ep, P, J, R, N), ``saa_prop`` (n_ep, P, J, R, S, 5)).

    ``greedy_rows`` / ``proposed_rows`` (host-static tuples) are the
    episode indices on those policies — policy-specific work runs only
    on its rows. Slot order (the fleet convention, mirrored by
    ``SimFleetRunner.run_reference``): scheduled churn -> SAA (epoch
    boundaries) -> plan -> Bernoulli departures -> repair -> price ->
    energy -> stochastic arrival -> AR(1) evolve; arrivals take effect
    the next slot. Returns a dict of slot-major stacked traces whose
    mask/xs/csize are the EXECUTED (post-repair) decision. Nothing here
    reads a tensor back to the host."""
    mu_f, mu_snr = data["mu_f"], data["mu_snr"]
    depart, arrive = data["depart"], data["arrive"]
    Ktgt, perm_rank = data["Ktgt"], data["perm_rank"]
    cst_full = data["cst_full"]
    device = mu_f.device
    E, N = mu_f.shape
    gi = torch.as_tensor(greedy_rows, dtype=_I64, device=device)
    pi = torch.as_tensor(proposed_rows, dtype=_I64, device=device)
    P = len(proposed_rows)
    by_compute = (data["layout_mode"] == LAYOUT_COMPUTE)[:, None]
    use_churn = p_depart > 0.0
    use_arr = p_arrive > 0.0
    use_saa = bool(saa_cuts) and P > 0
    gkw = dict(M=M, K=K, C=C, B=B, L=L, f_server_kappa=f_server_kappa,
               kappa=kappa, delta=gibbs_delta, chunk=cost_chunk)
    ckw = dict(B=B, L=L, C=C, f_server_kappa=f_server_kappa, kappa=kappa)
    # rows whose repair re-runs the greedy Alg. 3 (vs equal split)
    grr = tuple(sorted(set(greedy_rows) | set(proposed_rows)))
    gri = torch.as_tensor(grr, dtype=_I64, device=device)
    n_ar = torch.arange(N, device=device)
    is_res = n_ar >= N - n_reserve if n_reserve \
        else torch.zeros(N, dtype=torch.bool, device=device)

    if use_saa:
        vC = torch.as_tensor([v - 1 for v in saa_cuts], dtype=_I64,
                             device=device)
        V = len(saa_cuts)
        J = data["saa_eta"].shape[2]
        Rs = data["saa_key"].shape[3]
        Ss = data["saa_prop"].shape[4]
    if P:
        R = data["gkey"].shape[2]
        Gi = data["gprop"].shape[3]

    f = torch.clamp(mu_f + f_sigma * data["eta_f0"], min=_F_FLOOR)
    snr = mu_snr + snr_sigma * data["eta_s0"]
    energy = data["energy0"]
    depleted = torch.zeros((E, N), dtype=torch.bool, device=device)
    # devices scheduled to never be present (depart <= arrive) start
    # departed; reserve rows carry (T, T) sentinels and must not
    departed = (depart <= arrive) & ~is_res
    arrdyn = torch.zeros((E, N), dtype=torch.bool, device=device)
    v_idx = data["v0"]

    ys = {k: [] for k in ("f", "rate", "active", "n_active", "dev", "mask",
                          "xs", "csize", "cluster_latency", "latency",
                          "energy", "v")}
    for t in range(T):
        rate = bw * torch.log2(1.0 + 10.0 ** (snr / 10.0))

        # -- scheduled churn at slot start (gid order, floor-gated) ----
        arrived = (arrive <= t) | arrdyn
        alive = arrived & ~departed
        n0 = alive.sum(dim=1)
        sched = alive & (depart == t)
        ex = sched & (torch.cumsum(sched, dim=1)
                      <= (n0 - min_floor)[:, None])
        departed = departed | ex
        active = arrived & ~departed
        n_active = active.sum(dim=1)

        # -- large timescale: SAA cut re-selection (Alg. 2) ------------
        if use_saa and t % epoch_len == 0:
            ep = t // epoch_len
            eta = data["saa_eta"][ep]                # (P, J, 2, N)
            skey = data["saa_key"][ep]               # (P, J, R, N)
            sprop = data["saa_prop"][ep]             # (P, J, R, S, 5)
            muPf, muPs = mu_f[pi], mu_snr[pi]
            fJ = torch.clamp(muPf[:, None] + f_sigma * eta[:, :, 0],
                             min=_F_FLOOR)           # (P, J, N)
            rJ = bw * torch.log2(1.0 + 10.0 ** (
                (muPs[:, None] + snr_sigma * eta[:, :, 1]) / 10.0))
            G = P * V * J * Rs
            sh = (P, V, J, Rs)

            def bc(a, tail):
                return a.expand(sh + tail).reshape((G,) + tail)

            f_c = bc(fJ[:, None, :, None], (N,))
            r_c = bc(rJ[:, None, :, None], (N,))
            a_c = bc(active[pi][:, None, None, None], (N,))
            k_c = bc(Ktgt[pi][:, None, None, None], ())
            key_c = bc(skey[:, None], (N,))
            prop_c = bc(sprop[:, None], (Ss, 5))
            cst_c = {k: bc(a[vC][None, :, None, None], ())
                     for k, a in cst_full.items()}
            tot = _gibbs_cells(cst_c, f_c, r_c, a_c, k_c, key_c, prop_c,
                               **gkw)[4]
            tot = tot.reshape(sh).amin(dim=3)        # best-of-chains
            means = _sum_left_to_right(tot) / J      # (P, V)
            vstar = vC[torch.argmin(means, dim=1)]
            nP = active[pi].sum(dim=1)
            v_idx = v_idx.clone()
            v_idx[pi] = torch.where(nP > 0, vstar, v_idx[pi])

        cstE = {k: a[v_idx] for k, a in cst_full.items()}    # (E,)
        cst3 = {k: a[:, None, None] for k, a in cstE.items()}

        # -- small timescale: balanced layout (equal/greedy arms) ------
        sortval = torch.where(by_compute, f, perm_rank)
        order = torch.argsort(torch.where(active, sortval, float("inf")),
                              dim=1, stable=True)
        dev, mask, csize = _layout(order, n_active, Ktgt, M=M, K=K)

        # -- small timescale: Gibbs plan on the proposed rows ----------
        if P:
            gk = data["gkey"][t]                     # (P, R, N)
            gp = data["gprop"][t]                    # (P, R, Gi, 5)
            G2 = P * R
            f_c = f[pi][:, None].expand(P, R, N).reshape(G2, N)
            r_c = rate[pi][:, None].expand(P, R, N).reshape(G2, N)
            a_c = active[pi][:, None].expand(P, R, N).reshape(G2, N)
            k_c = Ktgt[pi][:, None].expand(P, R).reshape(G2)
            cst_c = {k: a[v_idx[pi]][:, None].expand(P, R).reshape(G2)
                     for k, a in cst_full.items()}
            dev_c, _, _, xs_c, tot_c = _gibbs_cells(
                cst_c, f_c, r_c, a_c, k_c, gk.reshape(G2, N),
                gp.reshape(G2, Gi, 5), **gkw)
            b = torch.argmin(tot_c.reshape(P, R), dim=1)  # best chain
            ar = torch.arange(P, device=device)
            # mask/csize equal the balanced layout's (swap-invariant)
            dev[pi] = dev_c.reshape(P, R, M, K)[ar, b]
            xs_p = xs_c.reshape(P, R, M, K)[ar, b]

        fd = _gather(f, dev)
        rd = _gather(rate, dev)
        xs = _equal_xs(csize, mask, C)
        if greedy_rows:
            # per-episode decisions are independent, so running greedy
            # on the greedy-policy rows alone is exact
            cst4g = {k: a[gi][:, None, None, None] for k, a in cstE.items()}
            xs[gi] = _greedy_xs(cst4g, fd[gi], rd[gi], mask[gi], csize[gi],
                                chunk=cost_chunk, **ckw)
        if P:
            xs[pi] = xs_p

        # -- Bernoulli departures + in-slot repair ---------------------
        if use_churn:
            u_t = data["u_dep"][t]
            wants = active & (u_t < p_depart)
            gone = wants & (torch.cumsum(wants, dim=1)
                            <= (n_active - min_floor)[:, None])
            departed = departed | gone
            member_gone = mask & _gather(gone, dev)
            affected = member_gone.any(dim=-1)                # (E, M)
            mask = mask & ~member_gone
            csize = mask.sum(dim=-1)
            xs_rep = _equal_xs(csize, mask, C)
            if grr:
                cst4r = {k: a[gri][:, None, None, None]
                         for k, a in cstE.items()}
                xs_rep[gri] = _greedy_xs(
                    cst4r, fd[gri], rd[gri], mask[gri], csize[gri],
                    chunk=cost_chunk, **ckw)
            xs = torch.where(affected[:, :, None], xs_rep, xs)

        clat = _cluster_latency_j(cst3, fd, rd, xs, mask, csize, **ckw)
        latency = _sum_left_to_right(clat)

        # -- energy drain of the executed round ------------------------
        if track_energy:
            fdk = fd * kappa
            t_comp = L * B * (cst3["gamma_dF"] + cst3["gamma_dB"]) / fdk
            t_tx = (L * B * cst3["xi_s"] + cst3["xi_d"]) / (xs * rd)
            j_slot = p_compute * t_comp + p_tx * t_tx
            # padded slots add exact zeros onto device 0 and every real
            # device sits in one slot, so the accumulation is exact in
            # any order
            j = torch.zeros((E, N), dtype=_F64, device=device).index_put_(
                (torch.arange(E, device=device)[:, None, None], dev),
                torch.where(mask, j_slot, 0.0), accumulate=True)
            if min_floor:
                # NetworkProcess.consume semantics: floor-pinned devices
                # stay active with the battery clamped at 0 and leave
                # (cause="energy_depleted") once the floor lifts; the
                # leave gate runs in gid order like the host loop
                executed = torch.zeros((E, N), dtype=_I32, device=device
                                       ).scatter_reduce_(
                    1, dev.reshape(E, -1), mask.reshape(E, -1).to(_I32),
                    reduce="amax").bool()
                n_alive2 = (arrived & ~departed).sum(dim=1)
                pinned = executed & depleted
                drain = executed & ~depleted
                e_un = torch.where(drain, energy - j, energy)
                newly = drain & (e_un <= 0.0)
                wants_leave = pinned | newly
                leave = wants_leave & (
                    torch.cumsum(wants_leave, dim=1)
                    <= (n_alive2 - min_floor)[:, None])
                departed = departed | leave
                depleted_next = depleted | newly
                energy_next = torch.where(drain, e_un.clamp(min=0.0),
                                          energy)
            else:
                e_un = energy - j
                depleted_next = depleted | (active & (e_un <= 0.0))
                departed = departed | (active & (e_un <= 0.0))
                energy_next = e_un.clamp(min=0.0)
        else:
            energy_next, depleted_next = energy, depleted

        # -- stochastic arrival (at most one per slot, next-slot) ------
        if use_arr:
            u_a = data["u_arr"][t]                            # (E,)
            cand = is_res & ~arrdyn & ~departed
            arr_now = (u_a < p_arrive) & cand.any(dim=1)
            idxr = torch.argmax(cand.to(_I32), dim=1)         # lowest gid
            arrdyn = arrdyn | ((n_ar == idxr[:, None]) & arr_now[:, None])

        # -- AR(1) evolution for the next slot -------------------------
        snr_next = mu_snr + rho_snr * (snr - mu_snr) \
            + coef_s * data["eps_s"][t]
        f_next = torch.clamp(
            mu_f + rho_f * (f - mu_f) + coef_f * data["eps_f"][t],
            min=_F_FLOOR)

        for k, a in (("f", f), ("rate", rate), ("active", active),
                     ("n_active", n_active), ("dev", dev), ("mask", mask),
                     ("xs", xs), ("csize", csize), ("cluster_latency", clat),
                     ("latency", latency), ("energy", energy_next),
                     ("v", v_idx + 1)):
            ys[k].append(a)
        f, snr, energy, depleted = f_next, snr_next, energy_next, \
            depleted_next
    return {k: torch.stack(v) for k, v in ys.items()}


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

class SimFleetRunner:
    """Prices a ``SimFleetCfg`` grid of dynamic-network episodes in one
    batched call (``run``) on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; no CUDA raises), with a decision-identical looped NumPy
    mirror (``run_reference`` / ``run_looped`` — the reference oracle and
    the bench baseline) and optional coupling to ``CPSL.run_fleet``
    (``train_curves``).

    Dynamics come from ``DynamicsCfg``: rho_snr / rho_f, the energy
    budget + power draws, ``forced_departures`` (converted to the
    per-device ``depart_slots`` schedule), and stochastic churn —
    ``p_depart`` Bernoulli departures (pre-drawn per-slot uniforms,
    decision-identical to ``NetworkProcess.sample_departures`` on shared
    draws) and ``p_arrive`` arrivals into ``SimFleetCfg.n_reserve``
    pre-provisioned reserve devices whose means are drawn host-side up
    front (``NetworkProcess`` draws them on the fly — the one remaining
    semantic difference). The ``min_devices`` floor applies when
    ``SimFleetCfg.min_devices_floor`` is set; otherwise every scheduled
    departure / depletion executes.

    The ``"proposed"`` policy runs the paper's full two-timescale
    controller: Gibbs + greedy (Algs. 3/4, best of ``gibbs_chains``
    lockstep chains) every slot, SAA cut re-selection (Alg. 2) every
    ``epoch_len`` slots over ``saa_cuts`` (None = keep the spec's fixed
    cut, no SAA), and in-slot spectrum repair after Bernoulli
    departures. All its randomness is pre-drawn per episode SEED, so
    same-seed arms stay CRN-coupled and ``run_reference`` can replay the
    identical decisions through the host ``TwoTimescaleController``
    ``draws=`` hooks.

    ``perms`` sets per-episode cluster orderings (default: device-id
    order): an (N,) / (E, N) array, or a ``{seed: permutation}`` dict —
    the dict form assigns each episode its seed's permutation without
    the caller having to know the runner's episode ordering (fig. 7
    keeps its per-run random clusters CRN-coupled across cuts this
    way); ``layout_modes`` (E,) selects rank (0, default) vs
    sort-by-current-compute (1) clustering; ``policy_overrides`` (E,)
    rewrites the grid's per-episode policy in place (fig. 8(b) builds
    its three arms over one seed axis this way); ``n_clusters`` caps
    the padded cluster axis M (default: worst-case ``ceil(N / k)``) —
    tightening it trips the capacity guard if the arrive/depart
    schedules could overflow ``M * cluster_size`` active devices.

    ``depart_slots`` / ``arrive_slots`` ((N,) or (E, N)) are explicit
    churn schedules; an explicit ``depart_slots`` WINS over
    ``DynamicsCfg.forced_departures`` (which is only consulted when no
    explicit schedule is given).

    The AR(1) innovations come from ``streams.fleet_innovations_rng``
    (module docstring); ``_eta_f0``, ``_eta_s0``, ``_eps_f`` and
    ``_eps_s`` are read at each ``run``, so a caller may replace them."""

    def __init__(self, prof: CutProfile, ncfg: NetworkCfg,
                 dcfg: DynamicsCfg, fcfg: SimFleetCfg, *,
                 perms=None,
                 layout_modes: Optional[Sequence[int]] = None,
                 depart_slots: Optional[np.ndarray] = None,
                 arrive_slots: Optional[np.ndarray] = None,
                 policy_overrides: Optional[Sequence[str]] = None,
                 n_clusters: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.prof, self.ncfg, self.dcfg, self.fcfg = prof, ncfg, dcfg, fcfg
        N_base, C, T = ncfg.n_devices, ncfg.n_subcarriers, fcfg.rounds
        for k in fcfg.cluster_sizes:
            assert 1 <= k <= C, f"cluster size {k} infeasible for C={C}"
        for p in fcfg.policies:
            assert p in ("equal", "greedy", "proposed"), p
        self.specs: List[dict] = [
            {"cut": int(v), "policy": p, "cluster_size": int(k),
             "seed": int(s)}
            for v in fcfg.cuts for p in fcfg.policies
            for k in fcfg.cluster_sizes for s in fcfg.seeds]
        if policy_overrides is not None:
            assert len(policy_overrides) == len(self.specs)
            for sp, p in zip(self.specs, policy_overrides):
                assert p in ("equal", "greedy", "proposed"), p
                sp["policy"] = p
        E = len(self.specs)
        n_res = int(fcfg.n_reserve) if dcfg.p_arrive > 0 else 0
        if dcfg.p_arrive > 0:
            assert fcfg.n_reserve > 0, \
                "stochastic arrivals need SimFleetCfg.n_reserve slots"
        N = N_base + n_res
        self.E, self.N, self.T = E, N, T
        self.N_base, self.n_reserve = N_base, n_res
        self.M = (int(n_clusters) if n_clusters is not None
                  else max(-(-N // k) for k in fcfg.cluster_sizes))
        self.K = max(fcfg.cluster_sizes)
        self.R = max(1, fcfg.gibbs_chains)
        self._min_floor = int(dcfg.min_devices) if fcfg.min_devices_floor \
            else 0
        seeds = sorted({sp["seed"] for sp in self.specs})

        def mean_seed(sp):
            return fcfg.mean_seed if fcfg.mean_seed is not None \
                else sp["seed"]

        means = {}
        for sp in self.specs:
            ms = mean_seed(sp)
            if ms not in means:
                mu_f, mu_snr = device_means(ncfg, ms)
                if n_res:
                    # reserve-device means, pre-drawn (NetworkProcess
                    # draws arrivals' means from its live stream; the
                    # fleet fixes them up front, per mean seed)
                    r = streams.fleet_reserve_means_rng(ms)
                    if ncfg.homogeneous:
                        rf = np.full(n_res, float(ncfg.f_homog))
                        rs_ = np.full(n_res, float(ncfg.snr_homog_db))
                    else:
                        rf = r.uniform(*ncfg.f_mean_range, size=n_res)
                        rs_ = r.uniform(*ncfg.snr_mean_range_db,
                                        size=n_res)
                    mu_f = np.concatenate([mu_f, rf])
                    mu_snr = np.concatenate([mu_snr, rs_])
                means[ms] = (mu_f, mu_snr)
        self._mu_f = np.stack([means[mean_seed(sp)][0]
                               for sp in self.specs]).astype(np.float64)
        self._mu_snr = np.stack([means[mean_seed(sp)][1]
                                 for sp in self.specs]).astype(np.float64)

        # per-episode innovation streams keyed by the episode SEED (same
        # seed -> same realization: CRN coupling across cuts/policies)
        draws = {s: streams.fleet_innovations_rng(dcfg.seed, s)
                 .standard_normal((T + 1, 2, N)) for s in seeds}
        stk = np.stack([draws[sp["seed"]] for sp in self.specs])  # (E,T+1,2,N)
        self._eta_f0, self._eta_s0 = stk[:, 0, 0], stk[:, 0, 1]
        self._eps_f = np.ascontiguousarray(
            stk[:, 1:, 0].transpose(1, 0, 2))                    # (T, E, N)
        self._eps_s = np.ascontiguousarray(stk[:, 1:, 1].transpose(1, 0, 2))

        self._cst_full = {k: np.asarray(getattr(prof, k), np.float64)
                          for k in _CST_KEYS}
        self._v0 = np.array([sp["cut"] - 1 for sp in self.specs], np.int32)
        self._Ktgt = np.array([sp["cluster_size"] for sp in self.specs],
                              np.int32)
        self._policy = np.array(
            [POLICY_PROPOSED if sp["policy"] == "proposed"
             else POLICY_GREEDY if sp["policy"] == "greedy"
             else POLICY_EQUAL for sp in self.specs], np.int32)
        self._grows = tuple(
            np.flatnonzero(self._policy == POLICY_GREEDY).tolist())
        self._prows = tuple(
            np.flatnonzero(self._policy == POLICY_PROPOSED).tolist())
        self._mode = (np.zeros(E, np.int32) if layout_modes is None
                      else np.asarray(layout_modes, np.int32))
        assert self._mode.shape == (E,)

        if perms is None:
            perms = np.arange(N)
        elif isinstance(perms, dict):
            perms = np.stack([np.asarray(perms[sp["seed"]], np.int64)
                              for sp in self.specs])
        else:
            perms = np.asarray(perms, np.int64)
        if n_res and perms.shape[-1] == N_base:
            # caller permutations cover the base population; reserve
            # devices append in gid order
            ext = np.broadcast_to(np.arange(N_base, N),
                                  perms.shape[:-1] + (n_res,))
            perms = np.concatenate([perms, ext], axis=-1)
        perms = np.broadcast_to(perms, (E, N))
        rank = np.empty((E, N), np.float64)
        for e in range(E):
            rank[e, perms[e]] = np.arange(N)
        self._perm_rank = rank

        # churn schedules: an explicit depart_slots wins outright;
        # forced_departures is the fallback
        self._depart = np.full((E, N), T, np.int64)
        if depart_slots is not None:
            self._depart[:, :N_base] = np.broadcast_to(
                np.asarray(depart_slots, np.int64), (E, N_base))
        else:
            for slot, ids in dcfg.forced_departures.items():
                for gid in ids:
                    if gid < N_base:
                        self._depart[:, gid] = np.minimum(
                            self._depart[:, gid], slot)
        self._arrive = np.zeros((E, N), np.int64)
        if n_res:
            self._arrive[:, N_base:] = T        # reserve: arrival-only
        if arrive_slots is not None:
            self._arrive[:, :N_base] = np.broadcast_to(
                np.asarray(arrive_slots, np.int64), (E, N_base))
        self._energy0 = np.full((E, N), float(dcfg.energy_budget_j))

        # capacity guard: _layout silently truncates clusters past M
        # rows, so the worst-case active count per the schedules must fit
        # M * cluster_size. With the floor on, blocked departures can
        # keep everyone alive -> departs ignored.
        t_ar = np.arange(max(T, 1))[:, None]
        for e, sp in enumerate(self.specs):
            ab = self._arrive[e, :N_base][None, :]
            db = self._depart[e, :N_base][None, :]
            present = (ab <= t_ar) if self._min_floor \
                else ((ab <= t_ar) & (t_ar < db))
            worst = int(present.sum(axis=1).max()) + n_res
            cap = self.M * sp["cluster_size"]
            if worst > cap:
                raise ValueError(
                    f"episode {e}: worst-case {worst} active devices "
                    f"exceed the M*K layout capacity {cap} "
                    f"(M={self.M}, cluster_size={sp['cluster_size']}); "
                    "raise n_clusters or trim the arrive/depart schedules")

        # pre-drawn uniforms, per episode seed (CRN across same-seed
        # arms; distinct fixed stream ids keep them independent)
        if dcfg.p_depart > 0:
            ud = {s: streams.fleet_departures_rng(dcfg.seed, s)
                  .random((T, N)) for s in seeds}
            self._u_dep = np.stack([ud[sp["seed"]] for sp in self.specs],
                                   axis=1)                    # (T, E, N)
        if dcfg.p_arrive > 0:
            ua = {s: streams.fleet_arrivals_rng(dcfg.seed, s).random(T)
                  for s in seeds}
            self._u_arr = np.stack([ua[sp["seed"]] for sp in self.specs],
                                   axis=1)                    # (T, E)
        self._use_saa = fcfg.saa_cuts is not None and bool(self._prows)
        if self._prows:
            R, Gi = self.R, fcfg.gibbs_iters
            gd = {}
            for s in seeds:
                r = streams.fleet_gibbs_rng(dcfg.seed, s)
                gd[s] = (r.random((T, R, N)), r.random((T, R, Gi, 5)))
            self._gkey = np.stack(
                [gd[self.specs[e]["seed"]][0] for e in self._prows],
                axis=1)                                       # (T,P,R,N)
            self._gprop = np.stack(
                [gd[self.specs[e]["seed"]][1] for e in self._prows],
                axis=1)                                       # (T,P,R,Gi,5)
        if self._use_saa:
            n_ep = -(-T // fcfg.epoch_len)
            J, S = fcfg.saa_samples, fcfg.saa_gibbs_iters
            sd = {}
            for s in seeds:
                r = streams.fleet_saa_rng(dcfg.seed, s)
                sd[s] = (r.standard_normal((n_ep, J, 2, N)),
                         r.random((n_ep, J, self.R, N)),
                         r.random((n_ep, J, self.R, S, 5)))
            self._saa_eta = np.stack(
                [sd[self.specs[e]["seed"]][0] for e in self._prows],
                axis=1)                                   # (n_ep,P,J,2,N)
            self._saa_key = np.stack(
                [sd[self.specs[e]["seed"]][1] for e in self._prows],
                axis=1)                                   # (n_ep,P,J,R,N)
            self._saa_prop = np.stack(
                [sd[self.specs[e]["seed"]][2] for e in self._prows],
                axis=1)                                   # (n_ep,P,J,R,S,5)

        self._sim_kw = dict(
            B=fcfg.batch_per_device, L=fcfg.local_epochs, C=C,
            M=self.M, K=self.K, T=T, bw=ncfg.subcarrier_bw,
            kappa=float(ncfg.kappa),
            f_server_kappa=ncfg.f_server * ncfg.kappa,
            f_sigma=float(ncfg.f_sigma), snr_sigma=float(ncfg.snr_sigma_db),
            rho_f=float(dcfg.rho_f), rho_snr=float(dcfg.rho_snr),
            coef_f=float(np.sqrt(1.0 - dcfg.rho_f ** 2) * ncfg.f_sigma),
            coef_s=float(np.sqrt(1.0 - dcfg.rho_snr ** 2)
                         * ncfg.snr_sigma_db),
            p_compute=float(dcfg.p_compute_w), p_tx=float(dcfg.p_tx_w),
            track_energy=dcfg.energy_budget_j > 0,
            greedy_rows=self._grows, proposed_rows=self._prows,
            gibbs_delta=float(fcfg.gibbs_delta),
            p_depart=float(dcfg.p_depart), p_arrive=float(dcfg.p_arrive),
            min_floor=self._min_floor, epoch_len=int(fcfg.epoch_len),
            saa_cuts=tuple(fcfg.saa_cuts) if self._use_saa else (),
            n_reserve=n_res, cost_chunk=int(fcfg.cost_chunk))

    # -- batched dispatch -----------------------------------------------------

    def sim_inputs(self) -> dict:
        """The ``_simulate`` argument dict: float64 / int64 tensors on the
        runner's device, one non-blocking copy each."""
        from repro_torch.core.cpsl import to_device

        dev = self.device

        def put(a, dtype=_F64):
            return to_device(a, dev, dtype)

        data = {"mu_f": put(self._mu_f), "mu_snr": put(self._mu_snr),
                "eta_f0": put(self._eta_f0), "eta_s0": put(self._eta_s0),
                "eps_f": put(self._eps_f), "eps_s": put(self._eps_s),
                "cst_full": {k: put(v) for k, v in self._cst_full.items()},
                "Ktgt": put(self._Ktgt, _I64),
                "layout_mode": put(self._mode, _I64),
                "perm_rank": put(self._perm_rank),
                "depart": put(self._depart, _I64),
                "arrive": put(self._arrive, _I64),
                "energy0": put(self._energy0), "v0": put(self._v0, _I64)}
        for name in ("u_dep", "u_arr", "gkey", "gprop",
                     "saa_eta", "saa_key", "saa_prop"):
            arr = getattr(self, "_" + name, None)
            if arr is not None:
                data[name] = put(arr)
        return data

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> dict:
        """The whole grid in one call. Returns ``{"episodes": [spec +
        latency_s/sim_time_s/n_active curves], "trace": {episode-major
        arrays}, "wall_s"}``; ``wall_s`` runs from the upload of the
        inputs to the last slot's results on the device."""
        t0 = time.monotonic()
        ys = _simulate(self.sim_inputs(), **self._sim_kw)
        self._sync()
        wall = time.monotonic() - t0
        trace = {k: v.cpu().numpy().swapaxes(0, 1) for k, v in ys.items()}
        cum = np.cumsum(trace["latency"], axis=1)
        episodes = []
        for e, sp in enumerate(self.specs):
            episodes.append(dict(
                sp, latency_s=trace["latency"][e].tolist(),
                sim_time_s=cum[e].tolist(),
                n_active=trace["n_active"][e].tolist()))
        return {"episodes": episodes, "trace": trace, "wall_s": wall}

    # -- looped NumPy mirror (oracle + bench baseline) ------------------------

    def run_reference(self, e: int) -> List[dict]:
        """Episode ``e`` replayed as a host NumPy loop — identical
        innovations, pre-drawn churn/controller uniforms, and decision
        rules, host ``round_latency`` pricing (the proposed arm goes
        through the real ``TwoTimescaleController`` on its ``draws=``
        hooks). Returns SimEngine-style per-round records."""
        from repro_torch.sim.batched import greedy_spectrum_batched

        sp = self.specs[e]
        ncfg, prof, dcfg, fcfg = self.ncfg, self.prof, self.dcfg, self.fcfg
        B, L = fcfg.batch_per_device, fcfg.local_epochs
        v, Ktgt = sp["cut"], sp["cluster_size"]
        policy = sp["policy"]
        proposed = policy == "proposed"
        C, N, T, R = ncfg.n_subcarriers, self.N, self.T, self.R
        mu_f, mu_snr = self._mu_f[e], self._mu_snr[e]
        coef_f = np.sqrt(1.0 - dcfg.rho_f ** 2) * ncfg.f_sigma
        coef_s = np.sqrt(1.0 - dcfg.rho_snr ** 2) * ncfg.snr_sigma_db
        track = dcfg.energy_budget_j > 0
        floor = self._min_floor
        c = prof.at(v)
        ctrl = None
        saa_on = False
        if proposed:
            from repro_torch.configs.base import SimCfg
            from repro_torch.sim.controller import TwoTimescaleController
            saa_on = fcfg.saa_cuts is not None
            scfg = SimCfg(rounds=T, epoch_len=fcfg.epoch_len,
                          cluster_size=Ktgt,
                          saa_samples=fcfg.saa_samples,
                          saa_gibbs_iters=fcfg.saa_gibbs_iters,
                          gibbs_iters=fcfg.gibbs_iters, gibbs_chains=R,
                          cuts=(tuple(fcfg.saa_cuts) if saa_on else (v,)),
                          seed=0)
            ctrl = TwoTimescaleController(prof, ncfg, B, L, scfg)
            ctrl.v = v
            p_loc = self._prows.index(e)

        f = np.maximum(mu_f + ncfg.f_sigma * self._eta_f0[e], _F_FLOOR)
        snr = mu_snr + ncfg.snr_sigma_db * self._eta_s0[e]
        energy = self._energy0[e].copy()
        depleted = np.zeros(N, dtype=bool)
        arrdyn = np.zeros(N, dtype=bool)
        is_res = np.arange(N) >= N - self.n_reserve if self.n_reserve \
            else np.zeros(N, dtype=bool)
        departed = ((self._depart[e] <= self._arrive[e]) & ~is_res)
        recs, sim_time = [], 0.0
        for t in range(T):
            # scheduled churn at slot start (gid order, floor-gated)
            arrived = (self._arrive[e] <= t) | arrdyn
            n_alive = int((arrived & ~departed).sum())
            for gid in np.flatnonzero(arrived & ~departed
                                      & (self._depart[e] == t)):
                if n_alive > floor:
                    departed[gid] = True
                    n_alive -= 1
            active = arrived & ~departed
            ids = np.flatnonzero(active)
            n = len(ids)
            rate = ncfg.subcarrier_bw * np.log2(1.0 + 10.0 ** (snr / 10.0))
            net = NetworkState(f=f.copy(), rate=rate)

            # large timescale (proposed arm): SAA cut re-selection
            if proposed and saa_on and t % fcfg.epoch_len == 0 and n:
                ep = t // fcfg.epoch_len
                J = fcfg.saa_samples
                draws = {
                    "eta": self._saa_eta[ep, p_loc][:, :, ids],
                    "gibbs": [[(self._saa_key[ep, p_loc, j, r][ids],
                                self._saa_prop[ep, p_loc, j, r])
                               for r in range(R)] for j in range(J)]}
                ctrl.select_cut(mu_f[ids], mu_snr[ids], t, draws=draws)
            v_t = ctrl.v if proposed else v

            # small timescale: the slot plan
            clusters: List[List[int]] = []
            xs: List[np.ndarray] = []
            if n:
                if proposed:
                    net_act = NetworkState(f=f[ids].copy(),
                                           rate=rate[ids].copy())
                    pd = [(self._gkey[t, p_loc, r][ids],
                           self._gprop[t, p_loc, r]) for r in range(R)]
                    plan = ctrl.plan_slot(net_act, ids, t, draws=pd)
                    clusters = plan.global_clusters()
                    xs = [np.asarray(x) for x in plan.xs]
                else:
                    sortval = (f if self._mode[e] == LAYOUT_COMPUTE
                               else self._perm_rank[e])
                    order = np.argsort(np.where(active, sortval, np.inf),
                                       kind="stable")
                    sizes = balanced_sizes(n, Ktgt)
                    bounds = np.concatenate([[0], np.cumsum(sizes)])
                    clusters = [[int(d) for d in
                                 order[bounds[m]:bounds[m + 1]]]
                                for m in range(len(sizes))]
                    for cl in clusters:
                        if policy == "greedy":
                            x, _ = greedy_spectrum_batched(
                                v_t, cl, net, ncfg, prof, B, L)
                        else:
                            x = equal_split_x(len(cl), C)
                        xs.append(np.asarray(x))

            # Bernoulli departures + in-slot repair
            gone: set = set()
            if dcfg.p_depart > 0:
                u = self._u_dep[t, e]
                n_act = n
                for gid in ids:
                    if n_act <= floor:
                        break
                    if u[gid] < dcfg.p_depart:
                        departed[gid] = True
                        gone.add(int(gid))
                        n_act -= 1
            if gone and clusters:
                kept_c, kept_x = [], []
                for cl, x in zip(clusters, xs):
                    keep = [d for d in cl if d not in gone]
                    if not keep:
                        continue
                    if len(keep) == len(cl):
                        kept_c.append(cl)
                        kept_x.append(x)
                    else:
                        if policy in ("greedy", "proposed"):
                            x2, _ = greedy_spectrum_batched(
                                v_t, keep, net, ncfg, prof, B, L)
                        else:
                            x2 = equal_split_x(len(keep), C)
                        kept_c.append(keep)
                        kept_x.append(np.asarray(x2))
                clusters, xs = kept_c, kept_x

            latency = (lt.round_latency(v_t, clusters, xs, net, ncfg,
                                        prof, B, L) if clusters else 0.0)
            sim_time += latency
            recs.append({"round": t, "v": int(v_t), "n_active": n,
                         "clusters": clusters,
                         "xs": [np.asarray(x) for x in xs],
                         "f": f.copy(), "rate": rate,
                         "latency_s": float(latency),
                         "sim_time_s": float(sim_time)})
            if not clusters:
                recs[-1]["skipped"] = "no active devices"

            # energy drain of the executed round
            if track and clusters:
                cv = prof.at(v_t) if proposed else c
                j = np.zeros(N)
                for cl, x in zip(clusters, xs):
                    for i, kx in zip(cl, np.asarray(x, np.float64)):
                        fi = f[i] * ncfg.kappa
                        t_comp = L * B * (cv["gamma_dF"]
                                          + cv["gamma_dB"]) / fi
                        t_tx = (L * B * cv["xi_s"] + cv["xi_d"]) \
                            / (kx * rate[i])
                        j[i] = (dcfg.p_compute_w * t_comp
                                + dcfg.p_tx_w * t_tx)
                executed = sorted(d for cl in clusters for d in cl)
                if floor:
                    n_act2 = int((arrived & ~departed).sum())
                    for gid in executed:
                        if depleted[gid]:        # floor-pinned earlier
                            if n_act2 > floor:
                                departed[gid] = True
                                n_act2 -= 1
                            continue
                        energy[gid] -= j[gid]
                        if energy[gid] <= 0:
                            energy[gid] = 0.0
                            depleted[gid] = True
                            if n_act2 > floor:
                                departed[gid] = True
                                n_act2 -= 1
                else:
                    exec_mask = np.zeros(N, dtype=bool)
                    exec_mask[executed] = True
                    e_un = energy - j
                    newly = exec_mask & (e_un <= 0.0)
                    depleted |= newly
                    departed |= newly
                    energy = np.maximum(e_un, 0.0)

            # stochastic arrival (at most one; effective next slot)
            if dcfg.p_arrive > 0:
                cand = np.flatnonzero(is_res & ~arrdyn & ~departed)
                if self._u_arr[t, e] < dcfg.p_arrive and len(cand):
                    arrdyn[cand[0]] = True

            snr = mu_snr + dcfg.rho_snr * (snr - mu_snr) \
                + coef_s * self._eps_s[t, e]
            f = np.maximum(mu_f + dcfg.rho_f * (f - mu_f)
                           + coef_f * self._eps_f[t, e], _F_FLOOR)
        return recs

    def run_looped(self) -> dict:
        """All episodes through ``run_reference`` — the host baseline the
        bench compares against. Returns ``{"latency": (E, T), "records",
        "wall_s"}``."""
        t0 = time.monotonic()
        records = [self.run_reference(e) for e in range(self.E)]
        wall = time.monotonic() - t0
        lat = np.array([[r["latency_s"] for r in recs] for recs in records])
        return {"latency": lat, "records": records, "wall_s": wall}

    # -- CPSL coupling --------------------------------------------------------

    def train_curves(self, result: dict, xtr, ytr, ccfg, *, xte=None,
                     yte=None, model: str = "lenet",
                     samples_per_device: int = 180,
                     eval_every: int = 0) -> List[dict]:
        """Joint latency x accuracy: run ``CPSL.run_fleet`` on the
        runner's device over the episodes' slot-0 cluster layouts and
        merge the loss/acc curves with the priced ``sim_time_s``.
        Requires a static scenario (no churn, no energy depletion —
        layouts must not change across rounds) and a single cut layer
        across the grid; clusters are wrap-padded to rectangular layouts
        exactly like ``SimEngine._padded_clusters``. Replica e's init is
        ``streams.model_generator(seed of e)``."""
        from repro_torch.core.cpsl import CPSL
        from repro_torch.core.splitting import make_split_model
        from repro_torch.data.pipeline import (DeviceResidentDataset,
                                               fleet_plan)
        from repro_torch.data.synthetic import non_iid_split

        assert (self._depart >= self.T).all() and \
            (self._arrive <= 0).all() and self.dcfg.energy_budget_j == 0, \
            "train_curves needs a static scenario (layouts fixed per round)"
        assert self.dcfg.p_depart == 0 and self.dcfg.p_arrive == 0 and \
            not self._prows, \
            "train_curves needs a static scenario (no churn, no Gibbs)"
        cuts = {sp["cut"] for sp in self.specs}
        assert len(cuts) == 1, "one cut layer per coupled fleet"
        v = cuts.pop()
        assert ccfg.batch_per_device == self.fcfg.batch_per_device \
            and ccfg.local_epochs == self.fcfg.local_epochs, \
            "training and pricing must agree on (B, L)"

        trace = result["trace"]
        layouts = []
        for e in range(self.E):
            mask0, dev0 = trace["mask"][e, 0], trace["dev"][e, 0]
            lay = [[int(d) for d, mk in zip(dr, mr) if mk]
                   for dr, mr in zip(dev0, mask0) if mr.any()]
            Kp = max(len(cl) for cl in lay)
            layouts.append([[cl[i % len(cl)] for i in range(Kp)]
                            for cl in lay])
        seeds = [sp["seed"] for sp in self.specs]
        shards = {s: non_iid_split(ytr, n_devices=self.N,
                                   samples_per_device=samples_per_device,
                                   seed=s) for s in set(seeds)}
        plan = fleet_plan([shards[s] for s in seeds],
                          ccfg.batch_per_device, layouts, seeds, self.T,
                          ccfg.local_epochs)
        M_pad, K_pad = plan.idx.shape[2], plan.idx.shape[4]
        ccfg2 = dataclasses.replace(ccfg, cut_layer=v, n_clusters=M_pad,
                                    cluster_size=K_pad)
        cpsl = CPSL(make_split_model(model, v, conv_impl=ccfg2.conv_impl),
                    ccfg2)
        dsd = DeviceResidentDataset(xtr, ytr, shards[seeds[0]],
                                    ccfg.batch_per_device,
                                    eval_images=xte, eval_labels=yte,
                                    device=self.device)
        states = cpsl.init_fleet_state(plan.seeds, self.device)
        states, metrics = cpsl.run_fleet(
            states, dsd.data, plan.idx, plan.weights,
            eval_data=dsd.eval_data if eval_every else None,
            eval_every=eval_every, cluster_mask=plan.cluster_mask,
            client_mask=plan.client_mask)
        loss = metrics["loss"].cpu().numpy()
        evals = metrics.get("eval")
        out = []
        for e, ep in enumerate(result["episodes"]):
            rep = dict(ep, loss=[float(x) for x in loss[e]])
            if evals is not None:
                rep["acc"] = [float(x) for x in
                              evals["acc"][e].cpu().numpy()]
                rep["eval_rounds"] = metrics["eval_rounds"]
            out.append(rep)
        return out


# --------------------------------------------------------------------------
# trace adapters (the NumPy oracle hooks)
# --------------------------------------------------------------------------

def fleet_trace_records(result: dict, e: int) -> List[dict]:
    """Episode ``e`` of a ``SimFleetRunner.run`` result as SimEngine-style
    per-round records — the format ``recompute_trace_latencies`` (and any
    JSONL trace consumer) already understands. Cluster entries are global
    device ids indexing the full-population ``f``/``rate`` rows; ``v``
    is the per-round traced cut (the proposed arm's SAA re-selects it
    at epoch boundaries)."""
    trace = result["trace"]
    v_tr = trace.get("v")
    v_fix = result["episodes"][e]["cut"]
    T = trace["latency"].shape[1]
    recs = []
    for t in range(T):
        mask, dev = trace["mask"][e, t], trace["dev"][e, t]
        clusters = [[int(d) for d, mk in zip(dr, mr) if mk]
                    for dr, mr in zip(dev, mask) if mr.any()]
        xs = [np.asarray([int(x) for x, mk in zip(xr, mr) if mk])
              for xr, mr in zip(trace["xs"][e, t], mask) if mr.any()]
        rec = {"round": t,
               "v": int(v_tr[e, t]) if v_tr is not None else int(v_fix),
               "clusters": clusters, "xs": xs,
               "f": trace["f"][e, t], "rate": trace["rate"][e, t],
               "latency_s": float(trace["latency"][e, t]),
               "n_active": int(trace["n_active"][e, t])}
        if not clusters:
            rec["skipped"] = "no active devices"
        recs.append(rec)
    return recs


def recompute_fleet_latencies(result: dict, prof: CutProfile,
                              ncfg: NetworkCfg, B: int, L: int
                              ) -> np.ndarray:
    """Re-derive every episode/round latency of a fleet result from its
    traced (f, rate, clusters, xs, v) with the NumPy
    ``core.latency.round_latency`` — the reference-oracle acceptance
    check for the tensor cost engine. Returns (E, T); rounds with no
    active devices recompute to 0."""
    E = result["trace"]["latency"].shape[0]
    out = []
    for e in range(E):
        row = []
        for rec in fleet_trace_records(result, e):
            if rec.get("skipped"):
                row.append(0.0)
                continue
            net = NetworkState(f=np.asarray(rec["f"], np.float64),
                               rate=np.asarray(rec["rate"], np.float64))
            row.append(lt.round_latency(rec["v"], rec["clusters"],
                                        rec["xs"], net, ncfg, prof, B, L))
        out.append(row)
    return np.asarray(out)
