"""The port's deployment runtime end to end on the CPU: real worker
processes (spawned, each its own torch) and a server over localhost.

The contract, as the reference's: a loopback run reproduces the
in-process looped ``CPSL.run_round`` (``loopback_reference``) bit for bit
— same rng streams, same batch index tables, same FedAvg — including
under retries (a dropped frame is resent and deduplicated); a device
that fails to upload is excluded from FedAvg with exactly the
simulated-dropout semantics (``zero_weight``); a mid-round disconnect
never hangs the run. Across packages, a deployment started from the
reference's initial state ends within ``tests/test_torch_cpsl.py``'s
round tolerance of the reference's ``loopback_reference``.

Bitwise equality on the CPU needs one intra-op thread on both sides
(``OMP_NUM_THREADS=1`` for the workers, which inherit the environment,
and one thread in this process). Heartbeats are given a generous
staleness limit (``hb_timeout_s``), so that a loaded test machine does
not turn a slow heartbeat into a straggler drop; every wait is bounded
by the runtime's own deadlines, and the orchestrator joins and, if
need be, terminates its workers on the way out.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import _cpsl_ref
from repro_torch import tree
from repro_torch.convert import cpsl_state_from_numpy
from repro_torch.core import cpsl as tcpsl
from repro_torch.rt.faults import FaultRule
from repro_torch.rt.orchestrator import (RTConfig, loopback_reference,
                                         run_loopback)
from repro_torch.rt.protocol import MsgType

STATE_KEYS = ("dev", "srv", "dev_opt", "srv_opt", "step")
ATOL_ROUND = 1e-6          # tests/test_torch_cpsl.py: per leaf, two rounds
LOSS_RTOL = 1e-5           # tests/test_torch_cpsl.py


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(**kw):
    base = dict(n_devices=2, cluster_size=2, rounds=1, local_epochs=1,
                batch=4, n_train=400, n_test=64, samples_per_device=60,
                phase_timeout_s=30.0, hb_timeout_s=30.0, ready_timeout_s=120.0,
                device="cpu")
    base.update(kw)
    return RTConfig(**base)


def assert_state_bit_exact(got, want):
    for key in STATE_KEYS:
        la, lb = tree.leaves(got[key]), tree.leaves(want[key])
        assert len(la) == len(lb), key
        for a, b in zip(la, lb):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a, b), \
                f"{key}: max diff {(a.double() - b.double()).abs().max()}"


def round_records(records):
    return [r for r in records if r.get("kind") != "qos"]


def test_loopback_bit_exact_two_clusters():
    """2 clusters x 2 devices, L = 2, 2 rounds: the multi-process runtime
    equals the in-process reference bit for bit (params, both optimizer
    states, step counter) and records its schedule."""
    cfg = cfg_of(n_devices=4, rounds=2, local_epochs=2)
    state, records = run_loopback(cfg)
    ref, ref_loss = loopback_reference(cfg)
    assert_state_bit_exact(state, ref)
    rounds = round_records(records)
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[-1]["loss"] == ref_loss
    for r in rounds:
        assert r["source"] == "rt" and r["dropped"] == []
        assert r["wall_s"] > 0 and r["planned_latency_s"] > 0
        assert r["clusters_global"] == [[0, 1], [2, 3]]
    qos = [r for r in records if r.get("kind") == "qos"]
    assert {"fwd", "bwd", "grad_wait", "upload", "server", "model_up",
            "round"} <= {q["phase"] for q in qos}
    assert int(state["step"]) == 2 * 2 * 2


def test_loopback_from_reference_state_matches_reference(monkeypatch):
    """The server starts from the reference's initial state (torch cannot
    draw JAX's threefry init): the deployment ends within the in-process
    round tolerance of the reference's own ``loopback_reference``."""
    cfg = cfg_of()
    with _cpsl_ref.reference() as ref:
        rorch = importlib.import_module("repro.rt.orchestrator")
        rcfg = rorch.RTConfig(**{
            k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "device"})
        import jax
        rc = ref.cpsl.CPSL(ref.splitting.make_split_model("lenet", cfg.cut),
                           rcfg.ccfg())
        init = jax.device_get(rc.init_state(ref.streams.model_key(cfg.seed)))
        rstate, rloss = rorch.loopback_reference(rcfg)
        rstate = jax.device_get(rstate)
    monkeypatch.setattr(tcpsl.CPSL, "init_state",
                        lambda self, gen: cpsl_state_from_numpy(init, "cpu"))
    state, records = run_loopback(cfg)
    assert round_records(records)[0]["loss"] == pytest.approx(
        float(rloss), rel=LOSS_RTOL)
    for key in STATE_KEYS:
        for a, b in zip(tree.leaves(state[key]), tree.leaves(rstate[key])):
            b = np.asarray(b)
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                tol = ATOL_ROUND * max(1.0, float(np.abs(b).max()))
                np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                           err_msg=key)


def test_retry_recovers_bit_exact():
    """A dropped SMASHED frame is retransmitted after the rpc timeout and
    the run still matches the reference exactly; the retry shows in
    QoS."""
    cfg = cfg_of(rpc_timeout_s=0.75, backoff_s=0.1,
                 faults={1: [FaultRule("drop", times=1,
                                       msg_types=(int(MsgType.SMASHED),))]})
    state, records = run_loopback(cfg)
    ref, _ = loopback_reference(cfg)
    assert_state_bit_exact(state, ref)
    assert round_records(records)[0]["dropped"] == []
    ups = [q for q in records if q.get("kind") == "qos"
           and q["phase"] == "upload" and q["device"] == 1]
    assert any(q.get("attempt", 0) > 0 for q in ups)


def test_failed_upload_matches_simulated_dropout():
    """A device whose AGG upload never arrives is excluded from FedAvg
    with exactly the simulated straggler-dropout semantics: bit-exact vs
    the reference with that device's eq.-8 weight zeroed."""
    cfg = cfg_of(phase_timeout_s=6.0, rpc_timeout_s=0.5, retries=2,
                 backoff_s=0.1,
                 faults={1: [FaultRule("drop",
                                       msg_types=(int(MsgType.AGG),))]})
    state, records = run_loopback(cfg)
    ref, _ = loopback_reference(cfg, zero_weight=(0, 1))
    assert_state_bit_exact(state, ref)
    assert round_records(records)[0]["dropped"] == [1]


def test_disconnect_mid_round_no_hang():
    """A device that hard-disconnects mid-run is detected (reader EOF),
    the epoch runs masked without it, and the run completes; round 0,
    before the fault, is the reference's round."""
    cfg = cfg_of(rounds=2,
                 faults={1: [FaultRule("disconnect", after=1,
                                       msg_types=(int(MsgType.SMASHED),))]})
    state, records = run_loopback(cfg)
    rounds = round_records(records)
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[0]["dropped"] == [] and rounds[1]["dropped"] == [1]
    for leaf in tree.leaves(state["dev"]) + tree.leaves(state["srv"]):
        assert bool(torch.isfinite(leaf).all())
    assert rounds[0]["loss"] == loopback_reference(cfg_of(rounds=1))[1]
