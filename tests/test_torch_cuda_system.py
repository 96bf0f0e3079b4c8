"""The port's host-driven paths on the card: the wireless-dynamics
simulator's grids against the port's looped NumPy oracle and its engine
training LeNet, the CPSL deployment runtime with 30 worker processes
(each its own CUDA context), its fault round and its chaos drill, the dry
run (every cell traced on ``meta``, its builders counted on ``meta`` and
on the card) and the static analysis's ``--check``. None of these paths
launches a hand-written kernel.

Every test is marked ``requires_cuda`` and skips on a host without a card.
The file imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda_system.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import streams, tree
from test_torch_cuda import cuda, launched  # noqa: F401

pytestmark = pytest.mark.requires_cuda

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
DRYRUN_CELLS = 32                  # 10 arches x their cells

# --------------------------------------------------------------------------
# the wireless-dynamics simulator
# --------------------------------------------------------------------------

# benchmarks/bench_simfleet.py's two grids at the paper's N = C = 30, K =
# 5, cut 3, B = 16, L = 1 on the LeNet profile, cut to 2 seeds and 20
# slots (each slot runs the same code; the forced departures and two SAA
# epochs fall inside): (grid, dynamics)
SIM_NET = dict(n_devices=30, n_subcarriers=30)
SIM_GRID = dict(seeds=(0, 1), cluster_sizes=(5,), cuts=(3,),
                batch_per_device=16, local_epochs=1, rounds=20)
SIM_CASES = {
    "bench": (dict(policies=("greedy", "equal")),
              dict(rho_snr=0.9, rho_f=0.95, seed=0,
                   forced_departures={5: (2,), 12: (7, 9)},
                   energy_budget_j=400.0)),
    "proposed": (dict(policies=("proposed",), epoch_len=10, gibbs_iters=25,
                      gibbs_chains=1, saa_samples=2, saa_gibbs_iters=12,
                      saa_cuts=(1, 2, 3), n_reserve=2,
                      min_devices_floor=True),
                 dict(rho_snr=0.9, rho_f=0.95, seed=0, p_depart=0.02,
                      p_arrive=0.1, min_devices=4, energy_budget_j=400.0)),
    # fig. 7 (benchmarks/fig7_cut_layer.py, full mode): 300 runs x every
    # LeNet cut, one slot, greedy, i.i.d. draws of the seed-0 population,
    # each run's random clustering keyed by its seed
    "fig7": None,
}
FIG7_RUNS, FIG7_SAMPLE = 300, 24   # runs; episodes checked against the oracle
SIM_RTOL = 1e-9                    # bench_simfleet: fleet vs looped host
SIM_RECOMPUTE_RTOL = 1e-12         # bench_simfleet: vs the NumPy oracle
SIM_TRACE_TOL = 1e-6               # examples/dynamics_sim.py
SIM_DECISIONS = ("dev", "mask", "csize", "xs", "v", "active", "n_active")


def _sim_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _sim_runner(case: str, device):
    from repro_torch.configs.base import SimFleetCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.fleet import SimFleetRunner
    prof = lenet_profile()
    if case != "fig7":
        grid, dyn = SIM_CASES[case]
        return SimFleetRunner(prof, NetworkCfg(**SIM_NET), DynamicsCfg(**dyn),
                              SimFleetCfg(**SIM_GRID, **grid), device=device)
    rng = np.random.default_rng(0)
    grid = dict(SIM_GRID, rounds=1, seeds=tuple(range(FIG7_RUNS)),
                policies=("greedy",), cuts=tuple(range(1, prof.n_cuts + 1)),
                mean_seed=0)
    return SimFleetRunner(prof, NetworkCfg(n_devices=30),
                          DynamicsCfg(rho_snr=0.0, rho_f=0.0, seed=0),
                          SimFleetCfg(**grid), device=device,
                          perms={s: rng.permutation(30)
                                 for s in range(FIG7_RUNS)})


@pytest.mark.parametrize("case", SIM_CASES)
def test_sim_grid_on_card_matches_run_reference(launched, cuda, case):
    """``SimFleetRunner.run`` on the card, twice: the same decisions both
    times; every episode (fig. 7: a sample) makes the port's looped NumPy
    ``run_reference``'s cut, cluster and allocation decisions every slot,
    its latencies within SIM_RTOL; the trace recomputes within
    SIM_RECOMPUTE_RTOL; every active cluster spends exactly the spectrum;
    no hand-written kernel runs."""
    from repro_torch.sim.engine import recompute_trace_latencies
    from repro_torch.sim.fleet import fleet_trace_records
    runner = _sim_runner(case, cuda)
    res, again = runner.run(), runner.run()
    for k in SIM_DECISIONS:
        np.testing.assert_array_equal(res["trace"][k], again["trace"][k],
                                      err_msg=k)
    E = runner.E
    episodes = range(0, E, E // FIG7_SAMPLE) if case == "fig7" else range(E)
    for e in episodes:
        want, got = runner.run_reference(e), fleet_trace_records(res, e)
        assert len(got) == len(want)
        for t, (g, w) in enumerate(zip(got, want)):
            assert (g["v"] == w["v"] and g["clusters"] == w["clusters"]
                    and len(g["xs"]) == len(w["xs"])
                    and all((a == b).all() for a, b in zip(g["xs"],
                                                           w["xs"]))), (e, t)
        assert _sim_rel([g["latency_s"] for g in got],
                        [w["latency_s"] for w in want]) <= SIM_RTOL, e
    want = recompute_trace_latencies(res, runner.prof, runner.ncfg,
                                     runner.fcfg.batch_per_device,
                                     runner.fcfg.local_epochs)
    assert _sim_rel(res["trace"]["latency"], want) <= SIM_RECOMPUTE_RTOL
    xs, mask = res["trace"]["xs"], res["trace"]["mask"]
    sums = np.where(mask, xs, 0).sum(axis=-1)
    assert (sums[res["trace"]["csize"] > 0]
            == runner.ncfg.n_subcarriers).all()
    assert not any(launched.values()), dict(launched)


def test_sim_engine_trains_on_card(launched, cuda, tmp_path):
    """``SimEngine`` at examples/dynamics_sim.py's setting, cut to 4
    rounds: LeNet trained on the card under churn, a forced departure,
    arrivals and batteries, with an eval each round; the JSONL trace
    recomputes within SIM_TRACE_TOL, the losses are finite and no
    hand-written kernel runs."""
    from repro_torch.configs.base import CPSLConfig, SimCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.data.pipeline import CPSLDataset
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
    from repro_torch.models import lenet
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.engine import SimEngine, recompute_trace_latencies
    xtr, ytr, xte, yte = synthetic_mnist(6000, 200, seed=0)
    idx = non_iid_split(ytr, n_devices=30, samples_per_device=180)
    prof, ncfg = lenet_profile(), NetworkCfg(n_devices=30)
    trace_path = tmp_path / "trace.jsonl"
    xte_d, yte_d = (torch.as_tensor(a, device=cuda) for a in (xte, yte))

    def eval_fn(cp, state):
        return lenet.accuracy(cp.export_params(state)[0], xte_d, yte_d)

    eng = SimEngine(
        "lenet", CPSLDataset(xtr, ytr, idx, batch=16), prof, ncfg,
        DynamicsCfg(rho_snr=0.9, rho_f=0.95, forced_departures={2: (7,)},
                    p_arrive=0.25, min_devices=10, energy_budget_j=500.0,
                    seed=0),
        SimCfg(rounds=4, epoch_len=2, cluster_size=5, saa_samples=2,
               saa_gibbs_iters=20, gibbs_iters=60, gibbs_chains=4,
               cuts=(2, 3, 4), trace_path=str(trace_path), seed=0),
        CPSLConfig(cluster_size=5, local_epochs=1, batch_per_device=16),
        eval_fn=eval_fn, device=cuda)
    eng.run(streams.model_generator(0, cuda))
    lines = [json.loads(x) for x in trace_path.read_text().splitlines()]
    rounds = [r for r in lines if not r.get("skipped")]
    want = recompute_trace_latencies(lines, prof, ncfg, 16, 1)
    err = float(np.abs(np.array([r["latency_s"] for r in rounds])
                       - want).max())
    assert err < SIM_TRACE_TOL
    assert rounds and np.isfinite([r["loss"] for r in rounds]).all()
    assert not any(launched.values()), dict(launched)


# --------------------------------------------------------------------------
# the deployment runtime: worker processes over localhost sockets
# --------------------------------------------------------------------------

# arXiv:2204.08119 §VIII-A at PERF.md §4's LeNet sizes: 30 device worker
# processes, 6 clusters of 5, B = 16, cut 3, L = 1
RT_PAPER = dict(n_devices=30, cluster_size=5, rounds=2, cut=3,
                local_epochs=1, batch=16, n_train=8000, n_test=1500,
                classes_per_device=3, samples_per_device=180, seed=0)
# examples/rt_loopback.py's deployment: eq. 15-25 delays injected at 0.05,
# device 3's round-1 model upload dropped
RT_EXAMPLE = dict(n_devices=4, cluster_size=2, rounds=3, local_epochs=1,
                  batch=8, n_train=600, n_test=64, samples_per_device=80,
                  seed=0, delay_scale=0.05, phase_timeout_s=6.0,
                  rpc_timeout_s=1.0, retries=2, backoff_s=0.2)
# its --chaos drill
RT_CHAOS = dict(n_devices=2, cluster_size=2, rounds=3, local_epochs=1,
                batch=4, n_train=400, n_test=64, samples_per_device=60,
                seed=0, phase_timeout_s=60.0, rejoin_timeout_s=60.0,
                reconnect_timeout_s=60.0, respawn=True, reconnect=True,
                cluster_retries=2)


def _rt_bit_equal(got, want):
    for key in ("dev", "dev_opt", "srv", "srv_opt", "step"):
        for a, b in zip(tree.leaves(got[key]), tree.leaves(want[key]),
                        strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a, b), key


def _rounds(records) -> list:
    return [r for r in records if r.get("kind") != "qos"]


def test_rt_paper_deployment_on_card_is_bit_equal(launched, cuda):
    """RT_PAPER as a deployment: 30 worker processes, each its own CUDA
    context, and the server in this process, 6 clusters of 5 in sequence,
    2 rounds. The final dev, dev_opt, srv, srv_opt and step equal the
    port's ``loopback_reference`` on the card bit for bit (deterministic
    cuDNN, no TF32, in every process); nobody is dropped; the server's
    process launches no hand-written kernel."""
    from repro_torch.rt.orchestrator import (Orchestrator, RTConfig,
                                             loopback_reference)
    torch.cuda.empty_cache()          # earlier tests' cached blocks
    cfg = RTConfig(device="cuda", **RT_PAPER)
    orch = Orchestrator(cfg)
    try:
        orch.start()
        state, records = orch.run()
    finally:
        orch.stop()
    ref, ref_loss = loopback_reference(cfg)
    _rt_bit_equal(state, ref)
    rounds = _rounds(records)
    assert [r["dropped"] for r in rounds] == [[]] * cfg.rounds
    assert rounds[-1]["loss"] == ref_loss
    assert not any(launched.values()), dict(launched)


def test_rt_example_drops_device_3_in_its_fault_round(cuda, tmp_path):
    """examples/rt_loopback.py's deployment on the card: round 1 drops
    exactly device 3 (its model upload is dropped), rounds 0 and 2
    nobody."""
    from repro_torch.rt.faults import FaultRule
    from repro_torch.rt.orchestrator import RTConfig, run_loopback
    from repro_torch.rt.protocol import MsgType
    cfg = RTConfig(device="cuda", trace_path=str(tmp_path / "example.jsonl"),
                   faults={3: [FaultRule("drop",
                                         msg_types=(int(MsgType.AGG),),
                                         rounds=(1,))]}, **RT_EXAMPLE)
    _, records = run_loopback(cfg)
    assert [r["dropped"] for r in _rounds(records)] == [[], [3], []]


def test_rt_chaos_drill_on_card_is_bit_equal(cuda, tmp_path):
    """``chaos_schedule(seed=7, kill_workers=1, kill_server=1)`` through
    ``run_elastic`` with a WAL: every round recorded, nobody dropped, the
    final state bit-equal to the fault-free ``loopback_reference``."""
    from repro_torch.rt.faults import chaos_schedule
    from repro_torch.rt.orchestrator import (RTConfig, loopback_reference,
                                             run_elastic)
    plan = chaos_schedule(seed=7, rounds=RT_CHAOS["rounds"],
                          n_devices=RT_CHAOS["n_devices"], kill_workers=1,
                          kill_server=1)
    cfg = RTConfig(device="cuda", faults=plan.worker_faults,
                   chaos_kill_server=plan.server_kill_rounds,
                   wal_dir=str(tmp_path / "wal"),
                   trace_path=str(tmp_path / "chaos.jsonl"), **RT_CHAOS)
    state, records = run_elastic(cfg)
    _rt_bit_equal(state, loopback_reference(cfg)[0])
    rounds = _rounds(records)
    assert [r["round"] for r in rounds] == list(range(cfg.rounds))
    assert not any(r["dropped"] for r in rounds), rounds


# --------------------------------------------------------------------------
# the dry run and the analysis
# --------------------------------------------------------------------------

# the dry run's builders at full width and depth (the counts follow the
# layer kinds), at short sequences: (label, arch, config changes, shape,
# the kernel, its launches). The training step is lm_train's setting: bf16
# compute, f32 params, remat, v = 1, K = 2, B = 2 a device, SGD at the
# CPSLConfig lrs; K1 2 (K v + 26 - v) = 54 times
LAUNCH_STEPS = {
    "gemma2-2b prefill": ("gemma2-2b", {"attn_impl": "pallas"},
                          ("gemma2_prefill", 512, 2, "prefill"),
                          "flash_attention", 26),
    "mamba2-2.7b prefill": ("mamba2-2.7b", {"ssd_impl": "pallas"},
                            ("mamba2_prefill", 512, 2, "prefill"), "ssd", 64),
    "gemma2-2b training step": (
        "gemma2-2b", {"attn_impl": "pallas", "dtype": "bfloat16",
                      "param_dtype": "float32", "remat": True,
                      "loss_chunk": 512},
        ("gemma2_train_step", 512, 4, "train"), "flash_attention", 54),
}


@pytest.mark.parametrize("label", LAUNCH_STEPS)
def test_dryrun_builders_count_the_card_run(launched, cuda, label):
    """A step built by the dry run's builders, once on ``meta`` (the
    estimate) and once on the card, each run under the op counter: the
    FLOPs and HBM bytes equal, and the custom calls equal on both and to
    the kernels' launches on the card (a Mamba-2 mixer's conv and gated
    output stages run their kernels once a layer too)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_host_mesh
    arch, over, shape, kernel, expect = LAUNCH_STEPS[label]
    cfg, shape = registry.get(arch).replace(**over), ShapeCfg(*shape)
    mesh = make_host_mesh(device="cuda")

    def build(device):
        if shape.kind == "prefill":
            return dryrun.build_prefill(cfg, shape, mesh, device=device)
        return dryrun.build_train(cfg, shape, mesh, 1, 2, ccfg_over=[
            "optimizer=sgd", "lr_device=0.05", "lr_server=0.25"],
            device=device)

    step, args = build("meta")
    est, _ = hlo_analysis.analyze(step, *args)
    step, args = build("cuda")
    before = dict(launched)
    run, _ = hlo_analysis.analyze(step, *args)
    torch.cuda.synchronize()
    assert (est.flops, est.hbm_bytes) == (run.flops, run.hbm_bytes)
    want = {kernel: expect, **({"gated_norm": expect, "causal_conv": expect}
                               if kernel == "ssd" else {})}
    assert dict(est.custom_calls) == want == dict(run.custom_calls)
    assert {k: launched[k] - before[k] for k in before} == {
        k: want.get(k, 0) for k in before}


def test_analysis_check_passes_on_card(cuda, tmp_path):
    """``python -m repro_torch.analysis --check`` on the card (rng_lint,
    thread_lint, JIT002 under sync-debug "error" and JIT003 on its four
    targets) against the empty baseline exits 0."""
    out = tmp_path / "ANALYSIS.json"
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check", "--out", str(out)], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    rep = json.loads(out.read_text())
    assert rep["jit_checks_run"] == ["JIT002", "JIT003"]
    assert len(rep["jit_targets"]) == 4


def test_dryrun_table_traces_every_cell(cuda, tmp_path):
    """``python -m repro_torch.launch.dryrun --all --mesh h100`` through
    the kernels' meta paths exits 0 with a record for each of the table's
    DRYRUN_CELLS cells at full size (peak memory, the roofline terms,
    MODEL_FLOPS). It traces on ``meta`` alone, but takes the host ~2 min,
    so it runs with the card's checks."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "h100", "--out", str(tmp_path), "--override",
         "attn_impl=pallas", "--override", "ssd_impl=pallas"],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert len(list(tmp_path.glob("*__h100.json"))) == DRYRUN_CELLS
