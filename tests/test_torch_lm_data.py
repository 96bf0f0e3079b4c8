"""Port parity for the split-LM slice's control plane: the LM batch
streams and the stream registry's repair, ``MarkovLM`` and
``LMClusterData`` batches (bit-equal to the reference's, seeded and
sequential), ``host_slice``, ``profile_for``, and the registry's shape
cells (``cells``, ``input_specs``, ``concrete_batch``)."""
import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import streams
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core.profile import profile_for
from repro_torch.data.pipeline import LMClusterData, host_slice
from repro_torch.data.synthetic import MarkovLM

PROFILE_FIELDS = ("xi_d", "xi_s", "xi_g", "gamma_dF", "gamma_dB",
                  "gamma_sF", "gamma_sB")

#: the reference's own pairs that can seed one stream once padded to four
#: words (fleet episode 6151 vs a bucket chain, episode 7433 vs an LM
#: batch); the formulas stay the reference's for bit-equal batches
KNOWN_PAIRS = {frozenset((fleet, other))
               for fleet in ("fleet_departures", "fleet_arrivals",
                             "fleet_gibbs", "fleet_saa")
               for other in ("bucket_chain", "lm_batch")}


@pytest.fixture(scope="module")
def ref():
    with _cpsl_ref.reference() as modules:
        yield modules


# --------------------------------------------------------------------------
# streams
# --------------------------------------------------------------------------

def _draw(rng, n=6):
    return rng.random(n)


def test_lm_streams_match_reference(ref):
    for seed, slot, dev in ((0, 0, 0), (5, 3, 2), (7, 8467, 0)):
        np.testing.assert_array_equal(
            _draw(streams.lm_batch_rng(seed, slot, dev)),
            _draw(ref.streams.lm_batch_rng(seed, slot, dev)))
    for seed, dev in ((0, 0), (3, 5)):
        np.testing.assert_array_equal(
            _draw(streams.lm_device_rng(seed, dev)),
            _draw(ref.streams.lm_device_rng(seed, dev)))


def test_seedsequence_pads_short_keys_with_zeros():
    """Why patterns are compared padded: a key and the same key with a
    trailing 0 draw the same numbers."""
    np.testing.assert_array_equal(
        _draw(np.random.default_rng((5, 7433, 8467))),
        _draw(np.random.default_rng((5, 7433, 8467, 0))))


def _names(problems):
    return {frozenset(p.split(":")[0].split(" and ")) for p in problems}


def test_registry_compares_padded_patterns():
    """Unpadded, the check missed every pair of unequal length. Padded,
    it finds exactly the reference's inherited pairs, which are allowed;
    the port's straggler stream collides with nothing once its rounds are
    bounded below the smallest tag."""
    assert streams.registry_overlaps() == []
    assert _names(streams.registry_overlaps(allowed=())) == KNOWN_PAIRS
    assert streams.INHERITED_OVERLAPS == KNOWN_PAIRS
    # a short pattern against a long one, told apart only by padding
    spec = streams.StreamSpec
    toy = {"a": spec("a", "tuple", (streams.Sym("s"), 7, 1), ""),
           "b": spec("b", "tuple", (streams.Sym("s"), 7, 1, 0), "")}
    assert _names(streams.registry_overlaps(toy)) == {frozenset("ab")}
    # the straggler round's bound is what keeps it apart
    unbounded = dict(streams.REGISTRY)
    unbounded["straggler"] = spec(
        "straggler", "tuple",
        (streams.Sym("seed"), streams.Sym("round"), streams.STRAGGLER_TAG),
        "")
    assert _names(streams.registry_overlaps(unbounded)) == {
        frozenset(("straggler", "bucket_chain")),
        frozenset(("straggler", "lm_batch"))}


def test_pairs_found_in_review_draw_alike_or_are_refused():
    """The three aliases found in review: the two through the straggler
    stream are refused now; the inherited fleet one is a known pair."""
    np.testing.assert_array_equal(
        _draw(np.random.default_rng((5, 7433, streams.STRAGGLER_TAG))),
        _draw(streams.lm_batch_rng(5, streams.STRAGGLER_TAG, 0)))
    for rnd in (7433, 6151, streams.ROUND_MAX):
        with pytest.raises(ValueError, match="straggler round"):
            streams.straggler_rng(5, rnd)
    streams.straggler_rng(5, streams.ROUND_MAX - 1)
    np.testing.assert_array_equal(
        _draw(np.random.default_rng((5, 6151, streams.FLEET_DEPART_TAG))),
        _draw(streams.bucket_chain_rng(5, streams.FLEET_DEPART_TAG, 0)))
    assert frozenset(("fleet_departures", "bucket_chain")) in KNOWN_PAIRS


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_markov_lm_matches_reference(ref):
    for V, eff, seed in ((211, 256, 0), (50304, 256, 3), (40, 16, 1)):
        t = MarkovLM(V, eff, seed)
        j = ref.synthetic.MarkovLM(V, eff, seed)
        assert t.eff == j.eff
        np.testing.assert_array_equal(t.cum, j.cum)
        a = t.sample(3, 17, np.random.default_rng(4))
        b = j.sample(3, 17, np.random.default_rng(4))
        for k in ("tokens", "labels"):
            assert a[k].dtype == np.int32 and a[k].shape == (3, 17)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:],
                                      a["labels"][:, :-1])


@pytest.mark.parametrize("seeded", [True, False])
def test_lm_cluster_data_matches_reference(ref, seeded):
    """Seeded draws are a pure function of (seed, slot, device), a device
    repeated in the list included; sequential draws walk each device's
    own stream."""
    t = LMClusterData(MarkovLM(211, seed=2), 5, 2, 12, seed=3)
    j = ref.pipeline.LMClusterData(ref.synthetic.MarkovLM(211, seed=2), 5,
                                   2, 12, seed=3)
    for i, devs in enumerate(([0, 1], [4, 2, 2], [3, 0])):
        seed = 100 + i if seeded else None
        a, b = t.cluster_batch(devs, seed=seed), \
            j.cluster_batch(devs, seed=seed)
        assert a["tokens"].shape == (len(devs), 2, 12)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        if seeded and len(devs) == 3:
            assert not np.array_equal(a["tokens"][1], a["tokens"][2])


def test_host_slice_matches_reference(ref):
    b = {"tokens": np.arange(48).reshape(4, 3, 4),
         "labels": np.arange(48).reshape(4, 3, 4) + 1}
    for host in range(2):
        a, c = host_slice(b, host, 2), ref.pipeline.host_slice(b, host, 2)
        for k in b:
            np.testing.assert_array_equal(a[k], c[k])
            assert a[k].shape == (2, 3, 4)


# --------------------------------------------------------------------------
# profiles and shape cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "paper", "gemma2-2b",
                                  "mamba2-2.7b", "qwen2-0.5b"])
def test_profile_for_matches_reference(ref, name):
    for seq in (64, 4096):
        t = profile_for(name, seq)
        j = ref.profile.profile_for(name, seq)
        assert t.name == j.name
        for f in PROFILE_FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    if name not in ("lenet", "paper"):
        t = profile_for(registry.get(name), 128)
        j = ref.profile.profile_for(ref.registry.get(name), 128)
        np.testing.assert_array_equal(t.xi_d, j.xi_d)


def test_cells_and_input_specs_match_reference(ref):
    assert set(SHAPES) == set(ref.configs.SHAPES)
    for arch in registry.list_archs():
        assert registry.cells(arch) == ref.registry.cells(arch)
        cfg, jcfg = registry.get(arch), ref.registry.get(arch)
        for cell in registry.cells(arch):
            shape, jshape = SHAPES[cell], ref.configs.SHAPES[cell]
            assert (shape.seq_len, shape.global_batch, shape.kind) == \
                (jshape.seq_len, jshape.global_batch, jshape.kind)
            specs = registry.input_specs(cfg, shape)
            jspecs = ref.registry.input_specs(jcfg, jshape)
            assert set(specs) == set(jspecs)
            for k, t in specs.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(jspecs[k].shape)
                assert str(t.dtype).split(".")[-1] == str(jspecs[k].dtype)


def test_concrete_batch_shapes():
    for arch in ("gemma2-2b", "mamba2-2.7b", "whisper-small"):
        cfg = registry.reduce_for_smoke(registry.get(arch))
        b = registry.concrete_batch(torch.Generator().manual_seed(0), cfg,
                                    batch=3, seq=10)
        for k in ("tokens", "labels"):
            assert b[k].shape == (3, 10) and b[k].dtype == torch.int32
            assert 0 <= int(b[k].min()) and int(b[k].max()) < cfg.vocab_size
        assert ("frames" in b) == cfg.encdec
        if cfg.encdec:
            assert b["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
