"""Random streams of the port.

Two kinds:

- ``torch.Generator`` roots (``model_generator``, ``sampler_generator``,
  ``warmup_generator``, and ``meta_generator`` for shape-only builds),
  counterparts of ``repro.streams.model_key``, ``sampler_key`` and
  ``warmup_key``. A torch generator does not reproduce JAX's threefry
  draws from the same seed, so tests that compare the two packages make
  their inputs with numpy and convert the reference's parameters instead
  of drawing them here.
- The NumPy stream registry the CPSL control plane draws from, copied
  from ``repro.streams`` with its positions and formulas unchanged, so the
  port's planner decisions, index tables and batches are bit-identical to
  the reference's. ``registry_overlaps`` checks the tuple pool for
  patterns that can seed one stream. NumPy's ``SeedSequence`` pads its
  entropy with zeros to four words, so ``(a, b, c)`` and ``(a, b, c, 0)``
  draw the same numbers: patterns are compared padded with a literal 0 to
  four positions. The port's own streams (``straggler``,
  ``fleet_innovations``) are registered beside copies of every reference
  pattern and alias none of them. The
  reference's fleet patterns can alias its ``bucket_chain`` and
  ``lm_batch`` streams at episodes 6151 and 7433; those pairs are
  ``INHERITED_OVERLAPS``, kept because the batches' bit-equality with the
  reference needs its formulas unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


def model_generator(seed: int, device="cuda") -> torch.Generator:
    """Model-parameter init root for ``models.api.init`` and
    ``core.cpsl.CPSL.init_state``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sampler_generator(seed: int, device="cuda") -> torch.Generator:
    """Prompt and token-sampling root for the serving demo."""
    return torch.Generator(device=device).manual_seed(int(seed))


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the initialisers
    draw on ``generator.device``, so from this one they build meta tensors
    (shapes and dtypes, no storage, nothing drawn)."""

    @property
    def device(self):
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    """Root for shape-only builds (the dry run's counterpart of
    ``jax.eval_shape``): params, optimizer state and caches come out on
    the ``meta`` device."""
    return _MetaGenerator().manual_seed(0)


def warmup_generator(device="cuda") -> torch.Generator:
    """Throwaway root for shape-only warm-up calls (the counterpart of
    ``repro.streams.warmup_key``): their results are discarded and never
    mix into trained state."""
    return torch.Generator(device=device).manual_seed(0)


# --------------------------------------------------------------------------
# registry machinery (as in repro.streams)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sym:
    """A free position in a tuple key pattern: any int in [lo, hi)."""
    name: str
    lo: int = 0
    hi: Optional[int] = None  # exclusive; None = unbounded

    def intersects(self, other: Union[int, "Sym"]) -> bool:
        if isinstance(other, Sym):
            lo = max(self.lo, other.lo)
            his = [h for h in (self.hi, other.hi) if h is not None]
            return lo < min(his) if his else True
        return self.lo <= other and (self.hi is None or other < self.hi)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One registered stream namespace."""
    name: str
    pool: str                                   # "tuple" | "scalar"
    key: Tuple[Union[int, Sym], ...]            # tuple pool: the pattern
    doc: str


def _positions_intersect(a, b) -> bool:
    if isinstance(a, Sym):
        return a.intersects(b)
    if isinstance(b, Sym):
        return b.intersects(a)
    return a == b


REGISTRY = {}


def _register(spec: StreamSpec) -> StreamSpec:
    assert spec.name not in REGISTRY, spec.name
    REGISTRY[spec.name] = spec
    return spec


#: SeedSequence's entropy pool: shorter keys are padded with zeros to it
POOL_WORDS = 4


def _padded(key, n: int) -> tuple:
    return tuple(key) + (0,) * (n - len(key))


def registry_overlaps(registry=None, allowed=None):
    """Check the tuple pool. Returns a list of problems (empty == proven
    disjoint): pairs of tuple patterns whose every position can collide
    at once after both are padded with 0 to ``POOL_WORDS`` positions (or
    to the longer one's length), and banned length-1 tuple patterns
    (SeedSequence hashes ``(s,)`` and ``s`` identically). Pairs named in
    ``allowed`` (default ``INHERITED_OVERLAPS``) are not reported."""
    registry = REGISTRY if registry is None else registry
    allowed = INHERITED_OVERLAPS if allowed is None else allowed
    problems = []
    tuples = [s for s in registry.values() if s.pool == "tuple"]
    for s in tuples:
        if len(s.key) < 2:
            problems.append(
                f"{s.name}: length-{len(s.key)} tuple pattern is banned "
                "(SeedSequence hashes (s,) and s identically)")
    for i, a in enumerate(tuples):
        for b in tuples[i + 1:]:
            if frozenset((a.name, b.name)) in allowed:
                continue
            n = max(POOL_WORDS, len(a.key), len(b.key))
            if all(_positions_intersect(x, y)
                   for x, y in zip(_padded(a.key, n), _padded(b.key, n))):
                problems.append(
                    f"{a.name} and {b.name}: patterns {a.key} / {b.key} "
                    "can collide")
    return problems


# --------------------------------------------------------------------------
# tuple pool: the reference's patterns, then the port's own
# --------------------------------------------------------------------------

#: Chain indices are bounded so ``(seed, chain)`` stays disjoint from the
#: tagged patterns (tags are >= 6151 > CHAIN_MAX).
CHAIN_MAX = 4096
FLEET_DEPART_TAG, FLEET_ARRIVE_TAG = 11, 13
FLEET_GIBBS_TAG, FLEET_SAA_TAG = 17, 19
FLEET_RESERVE_TAG, BUCKET_TAG, LM_TAG = 9967, 6151, 7433
#: the port's straggler keep tables, (seed, round, STRAGGLER_TAG); rounds
#: are bounded below the smallest second-position tag, so that
#: (seed, round, STRAGGLER_TAG, 0) stays disjoint from ``bucket_chain``
#: and ``lm_batch`` (and from the reserve means)
STRAGGLER_TAG = 8467
ROUND_MAX = min(BUCKET_TAG, LM_TAG, FLEET_RESERVE_TAG)
#: the port's fleet innovations, (seed, episode, FLEET_INNOV_TAG); episode
#: seeds are bounded like the straggler rounds, which keeps the pattern
#: apart from ``bucket_chain``, ``lm_batch`` and the reserve means
FLEET_INNOV_TAG = 23
EPISODE_MAX = ROUND_MAX

for _spec in (
        StreamSpec("chain", "tuple", (Sym("seed"), Sym("chain", 1, CHAIN_MAX)),
                   "Gibbs chain c >= 1; chain 0 is the scalar gibbs stream."),
        StreamSpec("bucket_chain", "tuple",
                   (Sym("seed"), BUCKET_TAG, Sym("bucket", 1), Sym("chain")),
                   "Hierarchical planner, chain c of bucket b >= 1."),
        StreamSpec("fleet_reserve_means", "tuple",
                   (Sym("mean_seed"), FLEET_RESERVE_TAG),
                   "Simulated fleet's reserve-pool channel means."),
        StreamSpec("fleet_departures", "tuple",
                   (Sym("seed"), Sym("episode"), FLEET_DEPART_TAG),
                   "Fleet churn departure uniforms."),
        StreamSpec("fleet_arrivals", "tuple",
                   (Sym("seed"), Sym("episode"), FLEET_ARRIVE_TAG),
                   "Fleet churn arrival uniforms."),
        StreamSpec("fleet_gibbs", "tuple",
                   (Sym("seed"), Sym("episode"), FLEET_GIBBS_TAG),
                   "Fleet in-jit Gibbs proposal draws."),
        StreamSpec("fleet_saa", "tuple",
                   (Sym("seed"), Sym("episode"), FLEET_SAA_TAG),
                   "Fleet SAA innovation and proposal draws."),
        StreamSpec("lm_batch", "tuple",
                   (Sym("seed"), LM_TAG, Sym("slot"), Sym("device")),
                   "Seeded LM pipeline batch draws per (slot, device)."),
        StreamSpec("straggler", "tuple",
                   (Sym("seed"), Sym("round", 0, ROUND_MAX), STRAGGLER_TAG),
                   "The port's per-round (M, K) straggler keep tables. The "
                   "reference draws its keep mask with jax.random.bernoulli "
                   "on the state's key, which torch cannot reproduce; the "
                   "port draws the table on the host and passes it to the "
                   "looped and the fused round alike."),
        StreamSpec("fleet_innovations", "tuple",
                   (Sym("seed"), Sym("episode", 0, EPISODE_MAX),
                    FLEET_INNOV_TAG),
                   "The port's fleet AR(1) innovations (T + 1, 2, N) per "
                   "episode seed. The reference draws them with "
                   "jax.random.normal on fold_in(PRNGKey(seed), episode), "
                   "which torch cannot reproduce.")):
    _register(_spec)


def chain_key(seed: int, chain: int):
    """The raw key for Gibbs chain ``chain``: ``seed`` itself for chain
    0 (the flat stream), ``(seed, chain)`` otherwise; planners thread it
    through ``gibbs_clustering(seed=...)``."""
    if chain == 0:
        return seed
    assert 0 < chain < CHAIN_MAX, chain
    return (int(seed), int(chain))


def chain_rng(seed: int, chain: int) -> np.random.Generator:
    return np.random.default_rng(chain_key(seed, chain))


def bucket_chain_rng(seed: int, bucket: int, chain: int) \
        -> np.random.Generator:
    """Chain ``chain`` of bucket ``bucket``; bucket 0 is the flat
    `chain` stream (bucket-0 == flat-plan bit-equality)."""
    if bucket == 0:
        return chain_rng(seed, chain)
    return np.random.default_rng(
        (int(seed), BUCKET_TAG, int(bucket), int(chain)))


def straggler_rng(seed: int, rnd: int) -> np.random.Generator:
    if not 0 <= rnd < ROUND_MAX:
        raise ValueError(f"straggler round {rnd} outside [0, {ROUND_MAX})")
    return np.random.default_rng((int(seed), int(rnd), STRAGGLER_TAG))


def fleet_reserve_means_rng(mean_seed: int) -> np.random.Generator:
    return np.random.default_rng((int(mean_seed), FLEET_RESERVE_TAG))


def fleet_departures_rng(seed: int, episode: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(episode), FLEET_DEPART_TAG))


def fleet_arrivals_rng(seed: int, episode: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(episode), FLEET_ARRIVE_TAG))


def fleet_gibbs_rng(seed: int, episode: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(episode), FLEET_GIBBS_TAG))


def fleet_saa_rng(seed: int, episode: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), int(episode), FLEET_SAA_TAG))


def fleet_innovations_rng(seed: int, episode: int) -> np.random.Generator:
    """The fleet's AR(1) innovations of episode seed ``episode``."""
    if not 0 <= episode < EPISODE_MAX:
        raise ValueError(
            f"fleet episode seed {episode} outside [0, {EPISODE_MAX})")
    return np.random.default_rng((int(seed), int(episode), FLEET_INNOV_TAG))


def lm_batch_rng(seed: int, slot: int, device: int) -> np.random.Generator:
    """Seeded ``LMClusterData`` draws, per (slot, device)."""
    return np.random.default_rng((int(seed), LM_TAG, int(slot), int(device)))


#: Reference pattern pairs that can seed one stream once padded to four
#: words: a fleet pattern (seed, episode, tag, 0) meets
#: (seed, BUCKET_TAG, bucket, chain) at episode 6151 and
#: (seed, LM_TAG, slot, device) at episode 7433. The formulas are the
#: reference's and stay as they are (batch and decision bit-equality).
INHERITED_OVERLAPS = frozenset(
    frozenset((fleet, other))
    for fleet in ("fleet_departures", "fleet_arrivals", "fleet_gibbs",
                  "fleet_saa")
    for other in ("bucket_chain", "lm_batch"))


# --------------------------------------------------------------------------
# scalar pool (offset-managed, exempt from the disjointness proof)
# --------------------------------------------------------------------------

for _name, _doc in (
        ("batch", "batch_seed(seed, rnd, m, l) = (seed*1_000_003 + rnd*971 "
                  "+ m*31 + l) % 2**31"),
        ("data", "Dataset synthesis and sequential CPSLDataset draws."),
        ("network_means", "device_means(cfg, seed)."),
        ("network_draw", "One-shot sample_network draw."),
        ("dynamics", "NetworkProcess innovations: seed + 1 (device_means "
                     "consumed seed)."),
        ("gibbs", "Alg. 4 Gibbs sampler: default_rng(seed)."),
        ("layout", "random_clustering layouts: default_rng(seed)."),
        ("saa_network", "SAA cut selection's network draws: seed + 1."),
        ("trainer_round", "Trainer per-round network draw: seed*1000 + rnd."),
        ("lm_device", "LMClusterData sequential per-device streams: "
                      "seed + 7*d."),
        ("curve", "equal_split_curve's network draws: default_rng(seed)."),
        ("chaos", "rt chaos-schedule draws: default_rng(seed).")):
    _register(StreamSpec(_name, "scalar", (), _doc))


def batch_seed(seed: int, rnd: int, m: int, l: int) -> int:  # noqa: E741
    """Per-(round, cluster, epoch) seed for batch draws."""
    return (seed * 1_000_003 + rnd * 971 + m * 31 + l) % (2 ** 31)


def batch_rng(seed: int, rnd: int, m: int, l: int) \
        -> np.random.Generator:  # noqa: E741
    return np.random.default_rng(batch_seed(seed, rnd, m, l))


def premixed_rng(seed: int) -> np.random.Generator:
    """A stream keyed by an already-mixed scalar (a ``batch_seed`` value)."""
    return np.random.default_rng(int(seed))


def data_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def network_means_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def network_draw_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def dynamics_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed + 1)


def gibbs_rng(seed) -> np.random.Generator:
    """Alg. 4's stream: an int, or a ``(seed, chain)`` tuple."""
    if isinstance(seed, tuple):
        s, c = seed
        return chain_rng(int(s), int(c))
    return np.random.default_rng(seed)


def layout_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def saa_network_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed + 1)


def trainer_round_rng(seed: int, rnd: int) -> np.random.Generator:
    return np.random.default_rng(seed * 1000 + rnd)


def lm_device_rng(seed: int, device: int) -> np.random.Generator:
    """Sequential (unseeded) ``LMClusterData`` draws of one device."""
    return np.random.default_rng(seed + 7 * device)


def curve_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def chaos_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)
