"""The round's plan, planned again: a plain NumPy copy of the paper's
latency model (eqs. 14-25), Alg. 3 (greedy subcarrier allocation) and
Alg. 4 (Gibbs-sampling clustering), with the per-cut cost profile of a
Mamba-2 LM (bits of the device-side model and of the smashed data, FLOPs
a sample on each side). Handed the same network draw and Gibbs seed as
the program, it must reach the same clusters and the same allocations.
"""
from __future__ import annotations

import math

import numpy as np

PARAM_BITS, ACT_BITS, BP_RATIO = 32, 16, 2.0


def mamba_profile(cfg: dict, seq: int) -> dict:
    """Per cut v in 1..V: xi_d, xi_s, xi_g (bits), gamma_dF/dB/sF/sB
    (FLOPs a sample)."""
    d = cfg["hidden_size"]
    d_inner = cfg["expand"] * d
    h = d_inner // cfg["head_dim"]
    gn = cfg["n_groups"] * cfg["state_size"]
    conv_dim = d_inner + 2 * gn
    d_in_proj = 2 * d_inner + 2 * gn + h
    k = cfg["conv_kernel"]
    params = (d * d_in_proj + k * conv_dim + conv_dim + 2 * h + d_inner
              + d_inner * d) + 2 * d
    flops = (2 * seq * (d * d_in_proj + d_inner * d) + 2 * seq * k * conv_dim
             + 2 * seq * cfg["chunk_size"] * h * cfg["head_dim"]
             + 4 * seq * h * cfg["state_size"] * cfg["head_dim"])
    n = cfg["num_hidden_layers"]
    total_flops = n * flops + 2 * seq * d * cfg["vocab_size"]
    v = np.arange(1, n + 1)
    xi_d = (cfg["vocab_size"] * d + v * params) * PARAM_BITS
    xi_s = np.full(n, float(seq * d * ACT_BITS))
    g_df = v * float(flops)
    g_sf = np.maximum(total_flops - g_df, 0.0)
    return {"xi_d": xi_d.astype(float), "xi_s": xi_s, "xi_g": xi_s.copy(),
            "gamma_dF": g_df, "gamma_dB": BP_RATIO * g_df,
            "gamma_sF": g_sf, "gamma_sB": BP_RATIO * g_sf}


def cluster_latency(v, devices, x, f, rate, net: dict, prof: dict, B: int,
                    L: int) -> float:
    c = {k: a[v - 1] for k, a in prof.items()}
    dev = np.asarray(devices)
    x = np.asarray(x, dtype=np.float64)
    fd = f[dev] * net["kappa"]
    r = rate[dev]
    C, K = net["n_subcarriers"], len(dev)
    tau_b = c["xi_d"] / (C * r)
    tau_d = B * c["gamma_dF"] / fd
    tau_s = B * c["xi_s"] / (x * r)
    tau_e = K * B * (c["gamma_sF"] + c["gamma_sB"]) / (
        net["f_server"] * net["kappa"])
    tau_g = c["xi_g"] / (x * r)
    tau_u = B * c["gamma_dB"] / fd
    tau_t = c["xi_d"] / (x * r)
    d_s = np.max(tau_b + tau_d + tau_s) + tau_e
    d_i = np.max(tau_g + tau_u + tau_d + tau_s) + tau_e
    d_e = np.max(tau_g + tau_u + tau_t)
    return float(d_s + (L - 1) * d_i + d_e)


def greedy_spectrum(v, devices, f, rate, net, prof, B, L):
    C, K = net["n_subcarriers"], len(devices)
    x = np.ones(K, dtype=np.int64)
    cur = cluster_latency(v, devices, x, f, rate, net, prof, B, L)
    for _ in range(C - K):
        cands = np.empty(K)
        for k in range(K):
            x[k] += 1
            cands[k] = cluster_latency(v, devices, x, f, rate, net, prof, B,
                                       L)
            x[k] -= 1
        best = int(np.argmin(cands))
        x[best] += 1
        cur = cands[best]
    return x, cur


def gibbs_clustering(v, f, rate, net, prof, B, L, M, K, iters, delta,
                     seed):
    """Returns (clusters, xs, latency)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(f))
    clusters = [list(order[m * K:(m + 1) * K]) for m in range(M)]
    cache = {}

    def total(cl):
        lat, xs = 0.0, []
        for ds in cl:
            key = tuple(sorted(ds))
            if key not in cache:
                cache[key] = greedy_spectrum(v, list(key), f, rate, net,
                                             prof, B, L)
            x, d = cache[key]
            rank = {dv: i for i, dv in enumerate(key)}
            xs.append(np.asarray(x)[[rank[dv] for dv in ds]])
            lat += d
        return lat, xs

    cur, xs = total(clusters)
    best = (cur, [list(c) for c in clusters], [x.copy() for x in xs])
    for _ in range(iters if M >= 2 else 0):
        m, mp = rng.choice(M, size=2, replace=False)
        i = rng.integers(len(clusters[m]))
        j = rng.integers(len(clusters[mp]))
        cand = [list(c) for c in clusters]
        cand[m][i], cand[mp][j] = cand[mp][j], cand[m][i]
        new, new_xs = total(cand)
        eps = 1.0 / (1.0 + math.exp(min((new - cur) / max(delta, 1e-12),
                                        700.0)))
        if rng.random() < eps:
            clusters, cur, xs = cand, new, new_xs
        if cur < best[0]:
            best = (cur, [list(c) for c in clusters], [x.copy() for x in xs])
    lat, cl, xs = best
    return ([[int(d) for d in c] for c in cl], [[int(a) for a in x]
                                                  for x in xs], lat)
