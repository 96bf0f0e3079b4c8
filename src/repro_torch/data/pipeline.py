"""Data pipeline: per-device local datasets -> CPSL cluster batches (the
port of ``repro.data.pipeline``).

``CPSLDataset`` owns the non-IID device shards and yields NumPy batches
shaped (K, B, ...) for the active cluster, the mini-batch draw of paper
eq. (4): NHWC float32 images and int32 labels.

``DeviceResidentDataset`` is its fused-round mirror: the dataset lives on
a device once, and each round the host computes only a small
(M, L, K, B) int32 index table, drawn from the same rng streams
``cluster_batch`` uses, that ``CPSL.run_round_fused`` gathers on the
device. The NumPy functions are copies of the reference's, so tables and
batches are bit-identical to it.

``fleet_plan`` builds an experiment fleet's padded (E, R, M, L, K, B)
tables, eq.-8 weights and masks for ``CPSL.run_fleet``.

``LMClusterData`` is the synthetic-LM counterpart of ``CPSLDataset``:
(K, B, S) int32 token and label batches from a ``MarkovLM``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, streams
from repro_torch.streams import batch_seed

__all__ = ["shard_sizes", "round_index_table", "batch_seed",
           "CPSLDataset", "DeviceResidentDataset", "FleetPlan", "fleet_plan",
           "LMClusterData", "host_slice"]


def shard_sizes(device_indices: List[np.ndarray],
                devices: Sequence[int]) -> np.ndarray:
    """Per-device local dataset sizes |D_{m,k}| — the eq. (8) weights."""
    return np.array([len(device_indices[d]) for d in devices], np.float32)


def round_index_table(device_indices: List[np.ndarray], batch: int,
                      clusters: Sequence[Sequence[int]], seed: int,
                      rnd: int, local_epochs: int) -> np.ndarray:
    """(M, L, K, B) int32 global sample indices for one round; row
    (m, l, k) is exactly the pick ``CPSLDataset.cluster_batch`` would
    draw for device ``clusters[m][k]`` at ``batch_seed(seed, rnd, m, l)``
    (same ``default_rng`` stream, same per-device call order — draws are
    prefix-stable, so appending padded slots never changes real rows)."""
    M, K = len(clusters), len(clusters[0])
    out = np.empty((M, local_epochs, K, batch), np.int32)
    for m, devices in enumerate(clusters):
        assert len(devices) == K, \
            "fused round needs rectangular (padded) clusters"
        for l in range(local_epochs):
            rng = streams.batch_rng(seed, rnd, m, l)
            for k, d in enumerate(devices):
                idx = device_indices[d]
                out[m, l, k] = rng.choice(idx, batch,
                                          replace=len(idx) < batch)
    return out


class CPSLDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 device_indices: List[np.ndarray], batch: int,
                 field_names=("image", "label"), seed: int = 0):
        self.x, self.y = images, labels
        self.device_indices = device_indices
        self.B = batch
        self.fields = field_names
        self.rng = streams.data_rng(seed)

    def data_sizes(self, devices: Sequence[int]) -> np.ndarray:
        return shard_sizes(self.device_indices, devices)

    def cluster_batch(self, devices: Sequence[int],
                      seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Draw a (K, B, ...) batch: device k samples B items from its own
        local dataset (paper: B_{m,k} subset of D_{m,k}). Passing ``seed``
        makes the draw a pure function of (seed, devices) — required for
        bit-exact restart-after-failure."""
        rng = streams.premixed_rng(seed) if seed is not None else self.rng
        xs, ys = [], []
        for d in devices:
            idx = self.device_indices[d]
            pick = rng.choice(idx, self.B, replace=len(idx) < self.B)
            xs.append(self.x[pick])
            ys.append(self.y[pick])
        return {self.fields[0]: np.stack(xs), self.fields[1]: np.stack(ys)}


class DeviceResidentDataset:
    """Dataset tensors on an explicit device plus per-round index tables
    for ``CPSL.run_round_fused``.

    ``data`` holds the full sample arrays (leading dim = sample count) on
    ``device``, which defaults to ``cuda`` and raises without CUDA unless
    the caller asks for ``cpu``. ``round_index_table`` reproduces, entry
    for entry, the draws ``CPSLDataset.cluster_batch(clusters[m],
    seed=batch_seed(seed, rnd, m, l))`` would make, so the on-device
    gather ``data[field][idx[m, l]]`` equals the host-side gather."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 device_indices: List[np.ndarray], batch: int,
                 field_names=("image", "label"), eval_images=None,
                 eval_labels=None, device="cuda"):
        self.device = resolve_device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.data = {field_names[0]: put(images), field_names[1]: put(labels)}
        self.device_indices = [np.asarray(d) for d in device_indices]
        self.B = batch
        self.fields = field_names
        self.eval_data: Optional[dict] = None
        if eval_images is not None:
            self.eval_data = {field_names[0]: put(eval_images),
                              field_names[1]: put(eval_labels)}

    @classmethod
    def from_dataset(cls, ds: "CPSLDataset", eval_images=None,
                     eval_labels=None, device="cuda"
                     ) -> "DeviceResidentDataset":
        return cls(ds.x, ds.y, ds.device_indices, ds.B, ds.fields,
                   eval_images, eval_labels, device=device)

    @classmethod
    def coerce(cls, dataset, device="cuda") -> "DeviceResidentDataset":
        """Accept a DeviceResidentDataset as-is, mirror an index-based
        dataset (one exposing ``device_indices``) onto ``device``, and
        reject generative datasets."""
        if isinstance(dataset, cls):
            return dataset
        if hasattr(dataset, "device_indices"):
            return cls.from_dataset(dataset, device=device)
        raise ValueError(
            "CPSLConfig.fused_round needs an index-based dataset "
            "(CPSLDataset / DeviceResidentDataset); generative datasets "
            "cannot be gathered on device")

    def data_sizes(self, devices: Sequence[int]) -> np.ndarray:
        return shard_sizes(self.device_indices, devices)

    def cluster_weights(self, clusters: Sequence[Sequence[int]]
                        ) -> np.ndarray:
        """(M, K) eq.-8 weights: per-client local dataset sizes."""
        return np.stack([self.data_sizes(c) for c in clusters])

    def round_index_table(self, clusters: Sequence[Sequence[int]],
                          seed: int, rnd: int, local_epochs: int
                          ) -> np.ndarray:
        """(M, L, K, B) int32 global sample indices for one round."""
        return round_index_table(self.device_indices, self.B, clusters,
                                 seed, rnd, local_epochs)

    def training_index_table(self, clusters: Sequence[Sequence[int]],
                             seed: int, rounds: int, local_epochs: int
                             ) -> np.ndarray:
        """(R, M, L, K, B): the round tables of a whole training curve
        (row r == ``round_index_table(..., rnd=r, ...)``)."""
        return np.stack([self.round_index_table(clusters, seed, r,
                                                local_epochs)
                         for r in range(rounds)])


@dataclass
class FleetPlan:
    """Padded per-replica tables for ``CPSL.run_fleet``.

    ``idx`` (E, R, M, L, K, B) int32 — replica e's training index table,
    zero-filled on padded slots; ``weights`` (E, M, K) eq.-8 data sizes
    with exact zeros on padded client slots (so FedAvg never weighs
    them); ``cluster_mask`` (E, M) / ``client_mask`` (E, M, K) mark the
    real slots (both ``None`` when every replica already has the common
    shape, so a homogeneous fleet runs the mask-free body)."""
    idx: np.ndarray
    weights: np.ndarray
    cluster_mask: Optional[np.ndarray]
    client_mask: Optional[np.ndarray]
    layouts: List[List[List[int]]]
    seeds: List[int]

    @property
    def n_replicas(self) -> int:
        return self.idx.shape[0]


def fleet_plan(shards: List[List[np.ndarray]], batch: int,
               layouts: List[List[List[int]]], seeds: Sequence[int],
               rounds: int, local_epochs: int,
               pad_to: Optional[tuple] = None) -> FleetPlan:
    """Build the batched-fleet tables: replica e draws its batches from
    shard table ``shards[e]`` over its own (rectangular) cluster layout
    ``layouts[e]`` with batch-seed stream ``seeds[e]``, then everything
    is padded to the grid's (max M, max K).

    Real rows are built on the unpadded layout, so they are bit-identical
    to the tables a solo run of that replica would use; padded slots get
    index 0 (a valid gather) and are masked out of the loss, FedAvg and
    metrics by the masks.

    ``pad_to``: an explicit (M, K) target overriding the grid max."""
    E = len(layouts)
    assert len(shards) == E and len(seeds) == E, (len(shards), len(seeds))
    Ms = [len(lay) for lay in layouts]
    Ks = [len(lay[0]) for lay in layouts]
    M, K = pad_to if pad_to is not None else (max(Ms), max(Ks))
    assert M >= max(Ms) and K >= max(Ks), (pad_to, Ms, Ks)
    homogeneous = all(m == M for m in Ms) and all(k == K for k in Ks)

    idx = np.zeros((E, rounds, M, local_epochs, K, batch), np.int32)
    weights = np.zeros((E, M, K), np.float32)
    cmask = np.zeros((E, M), bool)
    kmask = np.zeros((E, M, K), bool)
    for e, (lay, sh, seed) in enumerate(zip(layouts, shards, seeds)):
        for lay_m in lay:
            assert len(lay_m) == Ks[e], "replica layouts must be rectangular"
        real = np.stack([round_index_table(sh, batch, lay, seed, r,
                                           local_epochs)
                         for r in range(rounds)])
        idx[e, :, :Ms[e], :, :Ks[e]] = real
        weights[e, :Ms[e], :Ks[e]] = np.stack(
            [shard_sizes(sh, c) for c in lay])
        cmask[e, :Ms[e]] = True
        kmask[e, :Ms[e], :Ks[e]] = True
    return FleetPlan(idx, weights, None if homogeneous else cmask,
                     None if homogeneous else kmask,
                     [list(map(list, lay)) for lay in layouts],
                     [int(s) for s in seeds])


class LMClusterData:
    """Synthetic-LM equivalent: each simulated client has its own Markov
    seed (non-IID across clients)."""

    def __init__(self, lm, n_devices: int, batch: int, seq: int,
                 seed: int = 0):
        self.lm = lm
        self.B, self.S = batch, seq
        self.rngs = [streams.lm_device_rng(seed, d)
                     for d in range(n_devices)]

    def cluster_batch(self, devices: Sequence[int],
                      seed: Optional[int] = None):
        """``seed`` (as in ``CPSLDataset``) makes the draw a pure function
        of (seed, slot, device), as restartable trainers need. The slot
        index is mixed in so a device repeated in the list gets fresh
        samples rather than a bit-identical, double-weighted row."""
        if seed is not None:
            parts = [self.lm.sample(self.B, self.S,
                                    streams.lm_batch_rng(seed, i, d))
                     for i, d in enumerate(devices)]
        else:
            parts = [self.lm.sample(self.B, self.S, self.rngs[d])
                     for d in devices]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def host_slice(batch: Dict[str, np.ndarray], host_id: int, n_hosts: int
               ) -> Dict[str, np.ndarray]:
    """Shard the client axis across hosts: host ``host_id`` of
    ``n_hosts`` keeps its K / n_hosts rows."""
    def sl(t):
        per = t.shape[0] // n_hosts
        return t[host_id * per:(host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}
