"""Train CPSL under wireless network *dynamics* with the PyTorch port
(``repro_torch.sim``), on the card.

30 simulated devices with Gauss-Markov correlated fading and compute
drift, device churn (one scripted departure plus random arrivals), and
per-device energy budgets. The online two-timescale controller re-selects
the cut layer (Alg. 2, fully batched SAA) every ``epoch_len`` rounds and
re-runs clustering + spectrum allocation (Algs. 3/4) every round with
``gibbs_chains=4`` lockstep Gibbs replicas; departures that land
mid-round trigger the stale-decision repair path. The run trains the
paper's LeNet end to end and writes a JSONL trace, then re-derives every
round's wireless latency from the trace alone.

    PYTHONPATH=src python examples/torch_dynamics_sim.py [--device cpu]
        [--trace PATH]
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch import resolve_device, streams
from repro_torch.configs.base import CPSLConfig, SimCfg
from repro_torch.core.channel import NetworkCfg
from repro_torch.core.profile import lenet_profile
from repro_torch.data.pipeline import CPSLDataset
from repro_torch.data.synthetic import non_iid_split, synthetic_mnist
from repro_torch.models import lenet
from repro_torch.sim.dynamics import DynamicsCfg
from repro_torch.sim.engine import SimEngine, recompute_trace_latencies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_dynamics_trace.jsonl"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    xtr, ytr, xte, yte = synthetic_mnist(8000, 1500, seed=0)
    device_idx = non_iid_split(ytr, n_devices=30, samples_per_device=180)
    ds = CPSLDataset(xtr, ytr, device_idx, batch=16)
    ncfg = NetworkCfg(n_devices=30)
    prof = lenet_profile()

    ccfg = CPSLConfig(cluster_size=5, local_epochs=1, batch_per_device=16)
    scfg = SimCfg(rounds=8, epoch_len=4, cluster_size=5, saa_samples=2,
                  saa_gibbs_iters=20, gibbs_iters=60, gibbs_chains=4,
                  cuts=(2, 3, 4), trace_path=args.trace, seed=0)
    dcfg = DynamicsCfg(rho_snr=0.9, rho_f=0.95,       # correlated dynamics
                       forced_departures={2: (7,)},    # device 7 leaves
                       p_arrive=0.25, min_devices=10,
                       energy_budget_j=500.0, seed=0)

    def eval_fn(cp, state):
        params, _ = cp.export_params(state)
        return lenet.accuracy(params, xte, yte)

    eng = SimEngine("lenet", ds, prof, ncfg, dcfg, scfg, ccfg,
                    eval_fn=eval_fn, device=device)
    _, trace = eng.run(streams.model_generator(0, device))

    ms = {t["round"]: t for t in eng.timings}
    for r in trace:
        if r.get("skipped"):
            print(f"round {r['round']:2d}  SKIPPED ({r['skipped']})")
            continue
        evs = ", ".join(f"{e['kind']}@{e['device']}" for e in r["events"]) \
            or "-"
        t = ms[r["round"]]
        print(f"round {r['round']:2d}  v={r['v']}  N={r['n_active']:2d}  "
              f"loss {r['loss']:.3f}  acc {r['eval']:.3f}  "
              f"latency {r['latency_s']:6.2f}s (cum {r['sim_time_s']:7.1f}s)"
              f"  plan {t['plan_ms']:6.1f} ms  train {t['train_ms']:6.1f} ms"
              f"  {'STALE ' if r['stale'] else ''}events: {evs}")

    # the trace alone reproduces every round's wireless cost
    with open(args.trace) as f:
        lines = [json.loads(ln) for ln in f]
    got = np.array([r["latency_s"] for r in lines
                    if not r.get("skipped")])
    want = recompute_trace_latencies(lines, prof, ncfg,
                                     ccfg.batch_per_device,
                                     ccfg.local_epochs)
    err = np.abs(got - want).max()
    print(f"trace: {len(lines)} rounds -> {args.trace}  "
          f"(latency recompute err {err:.2e})")
    assert err < 1e-6


if __name__ == "__main__":
    main()
