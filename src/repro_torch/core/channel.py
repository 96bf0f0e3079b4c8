"""Wireless network model (paper §III, §V-B, §VIII-A).

Devices have time-varying compute f_n ~ N(mu_f_n, sigma_f^2) cycles/s and
channel SNR h_n ~ N(mu_h_n, sigma_h^2) dB (shadowing). Subcarrier rate is
Shannon: R = W log2(1 + SNR) bits/s (eq. 14 with the expectation folded
into the SNR draw). TDD => uplink and downlink rates identical (paper fn 3).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch import streams


@dataclass
class NetworkCfg:
    n_devices: int = 30
    subcarrier_bw: float = 1e6          # W = 1 MHz
    n_subcarriers: int = 30             # C (30 MHz total)
    f_server: float = 100e9             # f_s = 100 GHz-cycles/s
    kappa: float = 1.0                  # FLOPs per cycle
    # heterogeneity (paper §VIII-C): means drawn uniformly
    f_mean_range: tuple = (0.1e9, 1.0e9)
    snr_mean_range_db: tuple = (5.0, 30.0)
    f_sigma: float = 0.05e9
    snr_sigma_db: float = 2.0
    homogeneous: bool = False           # §VIII-B: identical devices
    f_homog: float = 0.5e9
    snr_homog_db: float = 17.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class NetworkState:
    """One draw of the network: per-device compute + per-subcarrier rate."""
    f: np.ndarray            # (N,) cycles/s
    rate: np.ndarray         # (N,) bits/s per subcarrier (UL == DL, TDD)


def device_means(cfg: NetworkCfg, seed: int = 0):
    rng = streams.network_means_rng(seed)
    if cfg.homogeneous:
        mu_f = np.full(cfg.n_devices, cfg.f_homog)
        mu_snr = np.full(cfg.n_devices, cfg.snr_homog_db)
    else:
        mu_f = rng.uniform(*cfg.f_mean_range, cfg.n_devices)
        mu_snr = rng.uniform(*cfg.snr_mean_range_db, cfg.n_devices)
    return mu_f, mu_snr


def sample_network(cfg: NetworkCfg, mu_f, mu_snr, rng) -> NetworkState:
    f = np.maximum(rng.normal(mu_f, cfg.f_sigma), 1e7)
    snr_db = rng.normal(mu_snr, cfg.snr_sigma_db)
    snr = 10.0 ** (snr_db / 10.0)
    rate = cfg.subcarrier_bw * np.log2(1.0 + snr)
    return NetworkState(f=f, rate=rate)
