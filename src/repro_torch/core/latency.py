"""CPSL training-latency model — exact implementation of paper §V eqs
(14)-(26).

Per cluster m the round is: starting phase d_S (eq. 19), (L-1) inner phases
d_I (eq. 22), ending phase d_E (eq. 24); per-round latency sums clusters
(eq. 25). All the straggler `max` terms are kept.

A ``CutProfile`` supplies the cut-layer-dependent constants:
  xi_d(v)   device-side model bytes->bits   (eq. 15, 23)
  xi_s(v)   smashed data bits per sample    (eq. 17)
  xi_g(v)   smashed-grad bits (paper treats this per *mini-batch*, eq. 20 —
            we follow the paper; physical_gradients=True uses B*xi_g)
  gamma_dF/dB(v), gamma_sF/sB(v) FLOPs per sample.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device, streams
from repro_torch.core.channel import NetworkCfg, NetworkState


@dataclass
class CutProfile:
    """Arrays indexed by cut layer v in {1..V} (index 0 == v=1)."""
    name: str
    xi_d: np.ndarray       # bits
    xi_s: np.ndarray       # bits per sample
    xi_g: np.ndarray       # bits (per mini-batch, paper eq. 20)
    gamma_dF: np.ndarray   # FLOPs per sample
    gamma_dB: np.ndarray
    gamma_sF: np.ndarray
    gamma_sB: np.ndarray

    @property
    def n_cuts(self) -> int:
        return len(self.xi_d)

    def at(self, v: int) -> dict:
        i = v - 1
        return {k: getattr(self, k)[i]
                for k in ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB",
                          "gamma_sF", "gamma_sB")}


def cluster_latency(v: int, devices: Sequence[int], x: np.ndarray,
                    net: NetworkState, ncfg: NetworkCfg, prof: CutProfile,
                    B: int, L: int, physical_gradients: bool = False
                    ) -> float:
    """Per-cluster round latency D_m (eqs. 15-24). ``x``: subcarriers per
    device in the cluster (len == len(devices))."""
    c = prof.at(v)
    dev = np.asarray(devices)
    x = np.asarray(x, dtype=np.float64)
    f = net.f[dev] * ncfg.kappa
    r = net.rate[dev]
    C = ncfg.n_subcarriers
    K = len(dev)
    xi_g = c["xi_g"] * (B if physical_gradients else 1.0)

    tau_b = c["xi_d"] / (C * r)                      # (15) model distribution
    tau_d = B * c["gamma_dF"] / f                    # (16) device FP
    tau_s = B * c["xi_s"] / (x * r)                  # (17) smashed uplink
    tau_e = K * B * (c["gamma_sF"] + c["gamma_sB"]) / (ncfg.f_server * ncfg.kappa)  # (18)
    tau_g = xi_g / (x * r)                           # (20) smashed-grad DL
    tau_u = B * c["gamma_dB"] / f                    # (21) device BP
    tau_t = c["xi_d"] / (x * r)                      # (23) device-model UL

    d_S = np.max(tau_b + tau_d + tau_s) + tau_e      # (19)
    d_I = np.max(tau_g + tau_u + tau_d + tau_s) + tau_e  # (22)
    d_E = np.max(tau_g + tau_u + tau_t)              # (24)
    return float(d_S + (L - 1) * d_I + d_E)          # D_m


class BatchedClusterEvaluator:
    """Vectorized ``cluster_latency`` for one fixed (cut layer, cluster,
    network draw): the single-cluster (sizes=[K]) special case of
    :class:`PartitionBatch` — one device row broadcast against whole
    (P, K) batches of candidate allocations per call.

    Exactness contract (inherited from ``PartitionBatch``, which keeps the
    operand order of ``cluster_latency``): the evaluated latencies are
    bit-identical to P scalar calls, so greedy/Gibbs *decisions* (argmins,
    Metropolis accepts) made on top of them match the looped
    implementations exactly. Tests assert this."""

    def __init__(self, v: int, devices: Sequence[int], net: NetworkState,
                 ncfg: NetworkCfg, prof: CutProfile, B: int, L: int,
                 physical_gradients: bool = False):
        dev = np.asarray(devices)
        self._pb = PartitionBatch(v, net, ncfg, prof, B, L, [len(dev)],
                                  dev[None, :],
                                  physical_gradients=physical_gradients)

    def latencies(self, xs: np.ndarray) -> np.ndarray:
        """(P, K) candidate allocations -> (P,) cluster latencies D_m."""
        return self._pb.latencies(xs)


class PartitionBatch:
    """Replicated-partition evaluator: scores R *full* M-cluster partitions
    — optionally each under its own cut layer and network draw — in a
    handful of broadcasts.

    Every replica uses the same cluster-size layout ``sizes`` = (K_1..K_M);
    ``device_idx`` is an (R, N) array of device ids laid out
    cluster-by-cluster (N = sum(sizes)), and allocations passed to
    :meth:`latencies` / :meth:`cluster_latencies` follow the same layout.
    ``v`` is an int (shared cut) or an (R,) array of per-replica cuts;
    ``net`` arrays are (N_dev,) for a single draw or (S, N_dev) for S
    stacked draws, with ``net_rows`` (R,) mapping replicas to draws.
    Broadcasting applies: a single device row (1, N) may be scored against
    (P, N) candidate allocations and vice versa.

    Exactness contract (same as ``BatchedClusterEvaluator``): every
    expression keeps the operand order of ``cluster_latency``, all in
    float64 — per-cluster latencies are bit-identical to scalar calls, and
    totals accumulate clusters left-to-right so they are bit-identical to
    the Python ``sum`` in ``round_latency`` and
    ``core.resource._round_latency_cached``. The multichain planner in
    ``repro.sim.batched`` relies on this to keep chain 0 of its lockstep
    Gibbs replicas bit-exact to the looped single-chain path."""

    def __init__(self, v, net: NetworkState, ncfg: NetworkCfg,
                 prof: CutProfile, B: int, L: int, sizes: Sequence[int],
                 device_idx: np.ndarray, net_rows=None,
                 physical_gradients: bool = False):
        sizes = np.asarray(sizes, dtype=np.int64)
        dev = np.asarray(device_idx, dtype=np.int64)
        if dev.ndim == 1:
            dev = dev[None, :]
        assert dev.shape[1] == int(sizes.sum()), \
            "device_idx must be laid out cluster-by-cluster per `sizes`"
        keys = ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB",
                "gamma_sF", "gamma_sB")
        v_arr = np.asarray(v)
        c = {k: np.asarray(getattr(prof, k))[v_arr - 1] for k in keys}
        if v_arr.ndim:                       # per-replica cuts -> columns
            c = {k: a[:, None] for k, a in c.items()}
        f_all = np.asarray(net.f, dtype=np.float64)
        r_all = np.asarray(net.rate, dtype=np.float64)
        if f_all.ndim == 1:
            f = f_all[dev] * ncfg.kappa
            self.r = r_all[dev]
        else:
            rows = np.asarray(net_rows, dtype=np.int64)[:, None]
            f = f_all[rows, dev] * ncfg.kappa
            self.r = r_all[rows, dev]
        C = ncfg.n_subcarriers
        self.L, self.M = L, len(sizes)
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        xi_g = c["xi_g"] * (B if physical_gradients else 1.0)
        tau_b = c["xi_d"] / (C * self.r)                 # (15)
        self.tau_d = B * c["gamma_dF"] / f               # (16)
        self.tau_e = sizes * B * (c["gamma_sF"] + c["gamma_sB"]) \
            / (ncfg.f_server * ncfg.kappa)               # (18), per cluster
        self.tau_u = B * c["gamma_dB"] / f               # (21)
        self.bd = tau_b + self.tau_d                     # partial sum of (19)
        self.num_s = B * c["xi_s"]                       # (17)
        self.num_g = xi_g                                # (20)
        self.num_t = c["xi_d"]                           # (23)

    def cluster_latencies(self, xs: np.ndarray) -> np.ndarray:
        """(R, N) allocations -> (R, M) per-cluster latencies D_m."""
        xs = np.asarray(xs, dtype=np.float64)
        if xs.ndim == 1:
            xs = xs[None, :]
        xr = xs * self.r
        tau_s = self.num_s / xr                          # (17)
        tau_g = self.num_g / xr                          # (20)
        tau_t = self.num_t / xr                          # (23)
        gu = tau_g + self.tau_u
        mx = np.maximum.reduceat
        d_S = mx(self.bd + tau_s, self.starts, axis=1) + self.tau_e  # (19)
        d_I = mx(gu + self.tau_d + tau_s, self.starts, axis=1) \
            + self.tau_e                                             # (22)
        d_E = mx(gu + tau_t, self.starts, axis=1)                    # (24)
        return d_S + (self.L - 1) * d_I + d_E

    def latencies(self, xs: np.ndarray) -> np.ndarray:
        """(R, N) allocations -> (R,) round totals, summed left-to-right
        over clusters (bit-identical to Python ``sum``, eq. 25)."""
        per = self.cluster_latencies(xs)
        total = per[:, 0].copy()
        for m in range(1, self.M):
            total = total + per[:, m]
        return total

    def device_scores(self, xs: np.ndarray) -> np.ndarray:
        """(R, N) allocations -> (R, N) per-device straggler scores: each
        device's summand inside the three phase maxima, combined as
        d_S + (L-1) d_I + d_E — the latency bound the device's current
        allocation enforces on its cluster. The top-k spectrum pruning
        (``core.resource.greedy_spectrum_topk``) restricts each greedy
        step's argmin to the k largest-score devices; only a straggler's
        increment can lower a phase max, so high-score devices are the
        only plausible winners."""
        xs = np.asarray(xs, dtype=np.float64)
        if xs.ndim == 1:
            xs = xs[None, :]
        xr = xs * self.r
        tau_s = self.num_s / xr                          # (17)
        tau_g = self.num_g / xr                          # (20)
        tau_t = self.num_t / xr                          # (23)
        gu = tau_g + self.tau_u
        return (self.bd + tau_s) + (self.L - 1) * (gu + self.tau_d + tau_s) \
            + (gu + tau_t)


def cluster_latency_batch(v: int, devices: Sequence[int], xs: np.ndarray,
                          net: NetworkState, ncfg: NetworkCfg,
                          prof: CutProfile, B: int, L: int,
                          physical_gradients: bool = False) -> np.ndarray:
    """One-shot form of ``BatchedClusterEvaluator``: evaluate P candidate
    allocations (``xs``: (P, K)) for a cluster, bit-identical to P scalar
    ``cluster_latency`` calls. Build the evaluator directly when scoring
    many batches for the same cluster."""
    return BatchedClusterEvaluator(
        v, devices, net, ncfg, prof, B, L,
        physical_gradients=physical_gradients).latencies(xs)


def equal_split_x(K: int, C: int) -> np.ndarray:
    """Feasible equal spectrum split for one K-device cluster: C // K
    subcarriers each, with the C mod K remainder handed one-by-one to the
    first devices — always sums to exactly C. Shared by
    ``equal_split_curve``, the benchmark baselines
    (``core.resource._uniform_xs``), and the jnp episode-fleet engine
    (``repro.sim.fleet``), which keeps the three in lockstep."""
    if K > C:
        raise ValueError(
            f"cluster of {K} devices exceeds the {C}-subcarrier budget "
            "(need at least one subcarrier per device)")
    base, rem = divmod(C, K)
    return np.full(K, base, dtype=np.int64) + (np.arange(K) < rem)


def round_latency(v: int, clusters: Sequence[Sequence[int]],
                  xs: Sequence[np.ndarray], net: NetworkState,
                  ncfg: NetworkCfg, prof: CutProfile, B: int, L: int,
                  physical_gradients: bool = False) -> float:
    """One-round latency D^t = sum_m D_m (eq. 25)."""
    return sum(cluster_latency(v, ds, x, net, ncfg, prof, B, L,
                               physical_gradients)
               for ds, x in zip(clusters, xs))


def equal_split_curve(v: int, clusters: Sequence[Sequence[int]],
                      ncfg: NetworkCfg, prof: CutProfile, B: int, L: int,
                      rounds: int, seed: int,
                      sl: bool = False) -> list:
    """Cumulative per-round wireless latency of a FIXED cluster layout
    under the equal spectrum split, networks redrawn each round from
    ``device_means(ncfg, seed)`` — the shared pricing loop behind the
    fig. 5/6 benchmarks and ``train.trainer.FleetRunner`` (their only
    difference is the cut convention each passes as ``v``). ``sl``
    prices the vanilla-SL sequential schedule instead."""
    from repro_torch.core.channel import device_means, sample_network

    mu_f, mu_snr = device_means(ncfg, seed)
    rng = streams.curve_rng(seed)
    # each cluster is priced at its OWN size: churn-balanced layouts are
    # routinely unequal (balanced_sizes emits e.g. [4, 3, 3]), and sizing
    # every cluster like the first one mis-prices (or crashes) them
    xs = [equal_split_x(len(c), ncfg.n_subcarriers) for c in clusters]
    t, out = 0.0, []
    for _ in range(rounds):
        net = sample_network(ncfg, mu_f, mu_snr, rng)
        if sl:
            t += vanilla_sl_round_latency(v, net, ncfg, prof, B)
        else:
            t += round_latency(v, clusters, xs, net, ncfg, prof, B, L)
        out.append(float(t))
    return out


# -- benchmark comparators (paper §VIII-B) ----------------------------------

def vanilla_sl_round_latency(v: int, net: NetworkState, ncfg: NetworkCfg,
                             prof: CutProfile, B: int,
                             iters_per_device: int = 1) -> float:
    """Vanilla SL: devices sequential, each uses ALL subcarriers. One visit
    per device: model DL + (FP + smashed UL + server + grad DL + BP) *
    iters + model UL."""
    c = prof.at(v)
    C = ncfg.n_subcarriers
    total = 0.0
    for n in range(len(net.f)):
        f = net.f[n] * ncfg.kappa
        r = net.rate[n] * C
        t_iter = (B * c["gamma_dF"] / f + B * c["xi_s"] / r
                  + B * (c["gamma_sF"] + c["gamma_sB"])
                  / (ncfg.f_server * ncfg.kappa)
                  + c["xi_g"] / r + B * c["gamma_dB"] / f)
        total += c["xi_d"] / r + iters_per_device * t_iter + c["xi_d"] / r
    return total


def fl_round_latency(net: NetworkState, ncfg: NetworkCfg, prof: CutProfile,
                     B: int, local_iters: int = 1) -> float:
    """FL: whole model trained on-device in parallel; equal subcarrier split.
    Uses v = V (empty server side): xi at the last cut = full model."""
    V = prof.n_cuts
    c = prof.at(V)
    whole_F = c["gamma_dF"] + c["gamma_sF"]
    whole_B = c["gamma_dB"] + c["gamma_sB"]
    xi_model = c["xi_d"]   # full model bits at v=V
    N = len(net.f)
    x = max(ncfg.n_subcarriers // N, 1)
    per_dev = (xi_model / (ncfg.n_subcarriers * net.rate)
               + local_iters * B * (whole_F + whole_B) / (net.f * ncfg.kappa)
               + xi_model / (x * net.rate))
    return float(np.max(per_dev))



# --------------------------------------------------------------------------
# tensor cost engine — eqs. (15)-(25), operand order of cluster_latency
# --------------------------------------------------------------------------

_CST_KEYS = ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB",
             "gamma_sF", "gamma_sB")


def _red(a):
    """A constant at the post-max rank (its singleton K axis dropped)."""
    return a[..., 0] if getattr(a, "ndim", 0) else a


def _cost_terms(cst, fd, rd, mask, csize, *, B: int, L: int, C: int,
                f_server_kappa: float, kappa: float,
                physical_gradients: bool = False) -> dict:
    """The allocation-independent terms of ``_cluster_latency_j``, each
    computed as its expression there computes it. The greedy allocator
    builds them once per call and re-prices only the allocation-dependent
    terms at each step (``_cost_with``).

    The slot mask is folded in here: ``bd`` and ``tau_u`` carry -inf in
    padded slots, so every phase sum is -inf there and the phase maxima
    need no masking of their own. A real slot's sums are the same
    operations on the same operands, so the values are the same bits."""
    f = fd * kappa
    xi_g = cst["xi_g"] * (B if physical_gradients else 1.0)
    tau_b = cst["xi_d"] / (C * rd)                   # (15)
    tau_d = B * cst["gamma_dF"] / f                  # (16)
    tau_e = csize * B * (_red(cst["gamma_sF"]) + _red(cst["gamma_sB"])) \
        / f_server_kappa                             # (18)
    tau_u = B * cst["gamma_dB"] / f                  # (21)
    ninf = float("-inf")
    return {"rd": rd, "bd": torch.where(mask, tau_b + tau_d, ninf),
            "tau_d": tau_d, "tau_e": tau_e,
            "tau_u": torch.where(mask, tau_u, ninf),
            "num_s": B * cst["xi_s"], "num_g": xi_g, "num_t": cst["xi_d"],
            "L": L, "live": csize > 0}


def _cost_with(terms: dict, xs):
    """Per-cluster latency D_m from ``_cost_terms`` and an allocation.
    With L = 1 the inner phase drops out: (L - 1) * d_I is +0.0 and
    d_S + 0.0 is d_S, so D = d_S + d_E is the same value."""
    xr = xs * terms["rd"]
    tau_s = terms["num_s"] / xr                      # (17)
    tau_g = terms["num_g"] / xr                      # (20)
    tau_t = terms["num_t"] / xr                      # (23)
    gu = tau_g + terms["tau_u"]
    d_S = (terms["bd"] + tau_s).amax(dim=-1) + terms["tau_e"]       # (19)
    d_E = (gu + tau_t).amax(dim=-1)                                 # (24)
    if terms["L"] == 1:
        D = d_S + d_E
    else:
        d_I = (gu + terms["tau_d"] + tau_s).amax(dim=-1) \
            + terms["tau_e"]                                        # (22)
        D = d_S + (terms["L"] - 1) * d_I + d_E
    return D.where(terms["live"], 0.0)


def _cluster_latency_j(cst, fd, rd, xs, mask, csize, *, B: int, L: int,
                       C: int, f_server_kappa: float, kappa: float,
                       physical_gradients: bool = False):
    """Masked tensor port of ``cluster_latency`` over (..., K) cluster
    rows (the reference's jnp ``_cluster_latency_j``).

    ``cst``: per-cut profile constants, float64 tensors whose leading
    axes end in singleton(s) so they broadcast against the (..., K)
    per-device terms; ``fd``/``rd``: gathered device compute / subcarrier
    rate; ``xs``: subcarrier allocation (padded slots must be >= 1);
    ``mask``: real device slots; ``csize``: real cluster size at the
    REDUCED rank (broadcastable against the (...,) per-cluster output; 0
    = padded cluster -> latency 0). Every expression keeps the operand
    order of the scalar NumPy path, term by term. Tensors stay on their
    device."""
    terms = _cost_terms(cst, fd, rd, mask, csize, B=B, L=L, C=C,
                        f_server_kappa=f_server_kappa, kappa=kappa,
                        physical_gradients=physical_gradients)
    return _cost_with(terms, xs)


def _sum_left_to_right(per_cluster):
    """(..., M) -> (...,) accumulated m = 0, 1, ... exactly like the
    Python ``sum`` in ``round_latency`` (padded clusters add exact 0.0,
    a bitwise no-op)."""
    total = per_cluster[..., 0]
    for m in range(1, per_cluster.shape[-1]):
        total = total + per_cluster[..., m]
    return total


class PartitionBatchJ:
    """Tensor port of :class:`PartitionBatch`: scores R full M-cluster
    partitions — optionally per-replica cuts and stacked network draws —
    through :func:`_cluster_latency_j` on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; no CUDA raises).

    Same constructor and ``cluster_latencies`` / ``latencies`` contract
    as the NumPy class (cluster-by-cluster ``sizes`` layout, (R, N)
    allocations, row broadcasting, NumPy results); at the default
    ``dtype=np.float64`` values agree with it to tight float64 tolerance
    on identical inputs (tests/test_torch_simfleet.py pins randomized
    (v, sizes, draws) grids).

    Population-scale knobs:

    * ``dtype=np.float32`` halves the cost-tensor footprint; parity with
      float64 is tolerance-tested rather than exact.
    * ``chunk_size=c`` evaluates :meth:`cluster_latencies` in tiles of c
      replica rows, bounding the per-term intermediates at (c, M, Kmax)
      instead of (R, M, Kmax). Rows are independent, so the results are
      bit-identical to the unchunked path for every chunk size."""

    def __init__(self, v, net: NetworkState, ncfg: NetworkCfg,
                 prof: CutProfile, B: int, L: int, sizes: Sequence[int],
                 device_idx: np.ndarray, net_rows=None,
                 physical_gradients: bool = False,
                 dtype=np.float64, chunk_size: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        sizes = np.asarray(sizes, dtype=np.int64)
        dev = np.asarray(device_idx, dtype=np.int64)
        if dev.ndim == 1:
            dev = dev[None, :]
        assert dev.shape[1] == int(sizes.sum()), \
            "device_idx must be laid out cluster-by-cluster per `sizes`"
        self.M, self.Kmax = len(sizes), int(sizes.max())
        self.N = int(sizes.sum())
        self.sizes = sizes
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.B, self.L = B, L
        self.C = ncfg.n_subcarriers
        self.kappa = float(ncfg.kappa)
        self.f_server_kappa = ncfg.f_server * ncfg.kappa
        self.physical = physical_gradients
        self.dtype = getattr(torch, np.dtype(dtype).name)
        self.chunk_size = int(chunk_size) if chunk_size else 0

        v_arr = np.asarray(v)
        cst = {k: np.asarray(getattr(prof, k), dtype=np.float64)[v_arr - 1]
               for k in _CST_KEYS}
        f_all = np.asarray(net.f, dtype=np.float64)
        r_all = np.asarray(net.rate, dtype=np.float64)
        if f_all.ndim == 1:
            fd, rd = f_all[dev], r_all[dev]
        else:
            rows = np.asarray(net_rows, dtype=np.int64)[:, None]
            fd, rd = f_all[rows, dev], r_all[rows, dev]

        def put(a):
            return torch.as_tensor(np.array(a, np.float64)).to(
                self.device, self.dtype)

        # (R?, M, Kmax) padded views + static slot masks
        self._mask = torch.as_tensor(
            self._to_slots(np.ones((1, self.N)), fill=0.0)[0] > 0.5,
            device=self.device)
        self._csize = torch.as_tensor(sizes, device=self.device)
        self._fd = put(self._to_slots(fd, fill=1.0))
        self._rd = put(self._to_slots(rd, fill=1.0))
        self._cst = {k: put(a)[..., None, None] if a.ndim else put(a)
                     for k, a in cst.items()}

    def _to_slots(self, arr: np.ndarray, fill: float) -> np.ndarray:
        """(R, N) cluster-by-cluster layout -> (R, M, Kmax) padded."""
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        out = np.full((arr.shape[0], self.M, self.Kmax), fill)
        for m, (s, k) in enumerate(zip(self.starts, self.sizes)):
            out[:, m, :k] = arr[:, s:s + k]
        return out

    def _eval(self, x, cst, fd, rd):
        return _cluster_latency_j(
            cst, fd, rd, x, self._mask, self._csize,
            B=self.B, L=self.L, C=self.C,
            f_server_kappa=self.f_server_kappa, kappa=self.kappa,
            physical_gradients=self.physical)

    def _eval_chunked(self, x):
        """Replica rows in tiles of ``chunk_size``: per-term
        intermediates are bounded at (chunk, M, Kmax)."""
        R = max(x.shape[0], self._fd.shape[0])

        def rows(a, lo, hi):
            return a.expand((R,) + tuple(a.shape[1:]))[lo:hi]

        out = []
        for lo in range(0, R, self.chunk_size):
            hi = min(lo + self.chunk_size, R)
            cst = {k: rows(a, lo, hi) if a.ndim else a
                   for k, a in self._cst.items()}
            out.append(self._eval(rows(x, lo, hi), cst,
                                  rows(self._fd, lo, hi),
                                  rows(self._rd, lo, hi)))
        return torch.cat(out)

    def cluster_latencies(self, xs: np.ndarray) -> np.ndarray:
        """(R, N) allocations -> (R, M) per-cluster latencies D_m."""
        x = torch.as_tensor(self._to_slots(np.asarray(xs, np.float64),
                                           fill=1.0)).to(self.device,
                                                         self.dtype)
        if self.chunk_size:
            D = self._eval_chunked(x)
        else:
            D = self._eval(x, self._cst, self._fd, self._rd)
        return D.cpu().numpy()

    def latencies(self, xs: np.ndarray) -> np.ndarray:
        """(R, N) allocations -> (R,) round totals (left-to-right cluster
        accumulation, as ``PartitionBatch.latencies``)."""
        return _sum_left_to_right(self.cluster_latencies(xs))
