"""Time-stepped wireless network process (the port's copy of
``repro.sim.dynamics``: NumPy, draw-for-draw equal to it).

Generalizes the i.i.d. per-round draws of ``core.channel.sample_network``
to a Gauss-Markov (AR(1)) process in both the shadowing SNR (dB) and the
device compute rate:

    s[t+1] = mu + rho * (s[t] - mu) + sqrt(1 - rho^2) * sigma * eps

whose stationary law is exactly the N(mu, sigma^2) of the static model, so
``rho = 0`` recovers the i.i.d. draws the rest of the repo was built on
while ``rho -> 1`` gives slowly varying channels that reward the paper's
small-timescale re-planning.

On top of the fading process the ``NetworkProcess`` tracks device churn
(Bernoulli departures/arrivals per slot, plus deterministic
``forced_departures`` for reproducible experiments) and optional per-device
energy budgets: ``consume`` drains a device's battery and emits a
depletion-departure event once it is empty.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import streams
from repro_torch.core.channel import NetworkCfg, NetworkState, device_means


@dataclass
class DynamicsCfg:
    rho_snr: float = 0.9             # AR(1) correlation of shadowing per slot
    rho_f: float = 0.95              # AR(1) correlation of compute drift
    p_depart: float = 0.0            # per-device departure prob per slot
    p_arrive: float = 0.0            # prob of one new device per slot
    min_devices: int = 2             # churn never drops below this
    energy_budget_j: float = 0.0     # per-device battery; 0 = unlimited
    p_compute_w: float = 0.8         # device compute power draw (W)
    p_tx_w: float = 0.2              # device transmit power (W)
    # slot -> global device ids forced to depart at that slot (deterministic
    # churn for tests / reproducible experiments)
    forced_departures: Dict[int, Tuple[int, ...]] = field(default_factory=dict)
    seed: int = 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Event:
    slot: int
    kind: str                        # depart | arrive | energy_depleted
    device: int                      # global device id
    # why a "depart" happened, when it wasn't plain churn — e.g. a
    # floor-pinned, already-depleted device finally leaving emits
    # kind="depart" with cause="energy_depleted" so trace consumers can
    # attribute the churn to energy (counting kinds alone undercounts it)
    cause: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"slot": self.slot, "kind": self.kind, "device": self.device}
        if self.cause is not None:
            d["cause"] = self.cause
        return d


class NetworkProcess:
    """Evolving population of wireless devices with correlated dynamics.

    Devices are identified by a *global id* (their birth index); arrays are
    append-only so ids stay stable across churn. ``snapshot`` exposes the
    currently active devices as a ``core.channel.NetworkState`` plus the
    local-index -> global-id map.
    """

    def __init__(self, ncfg: NetworkCfg, dcfg: DynamicsCfg):
        self.ncfg, self.dcfg = ncfg, dcfg
        # seed + 1: device_means consumes default_rng(seed); reusing the
        # same stream would couple the means to the fading innovations
        # (same convention as core.resource.saa_cut_selection)
        self.rng = streams.dynamics_rng(dcfg.seed)
        mu_f, mu_snr = device_means(ncfg, dcfg.seed)
        self.mu_f = np.array(mu_f, dtype=np.float64)
        self.mu_snr = np.array(mu_snr, dtype=np.float64)
        # start at a stationary draw (== one sample_network draw)
        self.f = np.maximum(
            self.rng.normal(self.mu_f, ncfg.f_sigma), 1e7)
        self.snr_db = self.rng.normal(self.mu_snr, ncfg.snr_sigma_db)
        self.active = np.ones(ncfg.n_devices, dtype=bool)
        self.energy = np.full(ncfg.n_devices, dcfg.energy_budget_j)
        self.slot = 0

    # -- views ----------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return len(self.f)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def active_ids(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    def snapshot(self) -> Tuple[NetworkState, np.ndarray]:
        """(NetworkState over active devices, local->global id map)."""
        ids = self.active_ids()
        snr = 10.0 ** (self.snr_db[ids] / 10.0)
        rate = self.ncfg.subcarrier_bw * np.log2(1.0 + snr)
        return NetworkState(f=self.f[ids].copy(), rate=rate), ids

    def means_of(self, ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids)
        return self.mu_f[ids].copy(), self.mu_snr[ids].copy()

    # -- dynamics -------------------------------------------------------------

    def evolve(self):
        """One AR(1) step of fading + compute drift; advances the slot."""
        d = self.dcfg
        c = self.ncfg
        n = self.n_devices
        eps_s = self.rng.standard_normal(n)
        eps_f = self.rng.standard_normal(n)
        self.snr_db = (self.mu_snr + d.rho_snr * (self.snr_db - self.mu_snr)
                       + np.sqrt(1.0 - d.rho_snr ** 2)
                       * c.snr_sigma_db * eps_s)
        self.f = np.maximum(
            self.mu_f + d.rho_f * (self.f - self.mu_f)
            + np.sqrt(1.0 - d.rho_f ** 2) * c.f_sigma * eps_f, 1e7)
        self.slot += 1

    def _depart(self, gid: int, kind: str, slot: Optional[int] = None,
                cause: Optional[str] = None) -> Event:
        self.active[gid] = False
        return Event(self.slot if slot is None else slot, kind, int(gid),
                     cause)

    def sample_departures(self, slot: Optional[int] = None,
                          u: Optional[np.ndarray] = None) -> List[Event]:
        """Forced + Bernoulli departures for ``slot`` (default: the
        process's current slot, which also stamps the events; never drops
        below ``min_devices`` active).

        ``u`` (optional, per-global-id uniforms) replaces the internal
        RNG for the Bernoulli decisions — device ``gid`` departs iff
        ``u[gid] < p_depart`` (subject to the floor). Lets an external
        simulator share one pre-drawn stream with this process and match
        its decisions exactly (the episode-fleet parity contract)."""
        slot = self.slot if slot is None else slot
        events: List[Event] = []
        for gid in self.dcfg.forced_departures.get(slot, ()):
            if gid >= self.n_devices:   # scheduled for a device never born
                continue
            if self.active[gid] and self.n_active > self.dcfg.min_devices:
                events.append(self._depart(gid, "depart", slot))
        if self.dcfg.p_depart > 0:
            for gid in self.active_ids():
                if self.n_active <= self.dcfg.min_devices:
                    break
                draw = self.rng.random() if u is None else float(u[gid])
                if draw < self.dcfg.p_depart:
                    events.append(self._depart(gid, "depart", slot))
        return events

    def sample_arrivals(self, u: Optional[float] = None) -> List[Event]:
        """At most one Bernoulli arrival per slot; new devices draw fresh
        means from the configured heterogeneity ranges. ``u`` (optional)
        replaces the internal RNG for the arrival decision (``u <
        p_arrive``); the new device's means/state still come from the
        process's own stream."""
        if self.dcfg.p_arrive <= 0:
            return []
        draw = self.rng.random() if u is None else float(u)
        if draw >= self.dcfg.p_arrive:
            return []
        c = self.ncfg
        if c.homogeneous:
            mu_f, mu_snr = c.f_homog, c.snr_homog_db
        else:
            mu_f = self.rng.uniform(*c.f_mean_range)
            mu_snr = self.rng.uniform(*c.snr_mean_range_db)
        gid = self.n_devices
        self.mu_f = np.append(self.mu_f, mu_f)
        self.mu_snr = np.append(self.mu_snr, mu_snr)
        self.f = np.append(self.f, max(
            self.rng.normal(mu_f, c.f_sigma), 1e7))
        self.snr_db = np.append(
            self.snr_db, self.rng.normal(mu_snr, c.snr_sigma_db))
        self.active = np.append(self.active, True)
        self.energy = np.append(self.energy, self.dcfg.energy_budget_j)
        return [Event(self.slot, "arrive", gid)]

    # -- energy ---------------------------------------------------------------

    def consume(self, ids: Sequence[int], joules: Sequence[float]
                ) -> List[Event]:
        """Drain per-device batteries; depleted devices leave the network.
        No-op when ``energy_budget_j == 0`` (unlimited).

        The ``min_devices`` floor takes precedence over depletion: a
        floor-pinned device stays active with its battery clamped at 0,
        and the one ``energy_depleted`` event is still emitted at the slot
        the battery actually ran out. When such a pinned device finally
        leaves (arrivals lifted the floor), the departure event carries
        ``cause="energy_depleted"`` so energy-driven churn stays countable
        even though the depletion itself was recorded slots earlier."""
        if self.dcfg.energy_budget_j <= 0:
            return []
        events: List[Event] = []
        for gid, j in zip(ids, joules):
            if not self.active[gid]:
                continue
            if self.energy[gid] <= 0:
                # pinned at the floor earlier; leave as soon as arrivals
                # lift the population above min_devices again
                if self.n_active > self.dcfg.min_devices:
                    events.append(self._depart(gid, "depart",
                                               cause="energy_depleted"))
                continue
            self.energy[gid] -= float(j)
            if self.energy[gid] <= 0:
                self.energy[gid] = 0.0
                if self.n_active > self.dcfg.min_devices:
                    events.append(self._depart(gid, "energy_depleted"))
                else:   # floor-pinned: record depletion, keep the device
                    events.append(Event(self.slot, "energy_depleted",
                                        int(gid)))
        return events
