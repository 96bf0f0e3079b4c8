"""The control of each cell's check, and the faults it must catch, read
on the card at the cell's own size (or, from the tests, at a small size
on the CPU).

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program-seeds 14,15,...]

For every seed the program runs its set-up (a training cell's first
round, a serving cell two generate calls) and the float32 reference
judges it, as a benchmark run does; then, in the program's place:

- the control, the reference computed in fp8 (``reference.precision``):
  a training cell's numbers, or a serving cell's gap of the token the
  fp8 reference puts first at each served position;
- a training cell's faults: half of each batch left out, the mean taken
  over the rest (the reference on half the rows); each step's loss
  reported 1 % off where the step produces it.

A state left unchanged reads 1 by the change's measure, and needs no
run. Each reading is judged as a run judges the program (``run.judge``,
at the cell's limits): one JSON line a seed, the program's numbers and
each of these, each with its ``correct``. The exit code is 1 where the
control or a fault came out correct, or the program did not.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _run(cell: str, seed: int, device, config=None, traffic=None):
    import torch
    from perfbench.harness import bench
    from perfbench.run import Run
    man = bench.manifest()
    entry = bench.cell(man, cell)
    wl = bench.workload_file(cell)
    cfg = config or bench.config_file(man, entry["config"])
    rec = bench.Record(cfg, traffic or wl["params"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(seed, 0.0, False, torch.device(device), cfg, rec.traffic, rec)
    return run, bench.load_module("drivers", wl["driver"])


def judged(readings: dict, limits: dict) -> dict:
    """``readings`` with the run's ``correct`` at the cell's ``limits``."""
    from perfbench.run import judge
    checks = [(n, float(readings[n]), lim) for n, lim in limits.items()]
    return dict(readings, correct=judge(checks))


def train_readings(cell: str, seed: int, device, config=None,
                   traffic=None, control: bool = True) -> dict:
    run, drv = _run(cell, seed, device, config, traffic)
    from perfbench.run import judge
    drv.prepare(run)
    checks = drv.verify(run)
    program = dict({name: v for name, v, _ in checks}, correct=judge(checks))
    first = {"losses": run.first_losses, "grad": run.first_grad,
             "change": run.first_change}
    leaves = drv.readings(run, first, run.reference, True)
    if not control:
        return {"seed": seed, "program": program, "program_leaves": leaves}
    limits = run.traffic["limits"]
    ctrl = drv.reference_round(run, "fp8")
    b = run.traffic["batch_per_device"]
    half = drv.reference_round(run, "float32", batch_rows=slice(0, b // 2))
    altered = dict(first, losses=[x * 1.01 for x in run.first_losses])
    return {"seed": seed, "program": program, "program_leaves": leaves,
            "control": judged(drv.readings(run, ctrl, run.reference, True),
                              limits),
            "half_batch": judged(drv.readings(run, half, run.reference),
                                 limits),
            "loss_altered": judged(drv.readings(run, altered,
                                                run.reference), limits)}


def serve_readings(cell: str, seed: int, device, config=None,
                   traffic=None, control: bool = True) -> dict:
    from perfbench.reference import compare
    run, drv = _run(cell, seed, device, config, traffic)
    from perfbench.run import judge
    drv.prepare(run)
    run.min_calls = 2
    drv.window(run)
    correct = judge(drv.verify(run))
    program = dict(run.readings, correct=correct)
    if not control:
        return {"seed": seed, "program": program}
    ctrl = drv.reference_logits(run, run.seqs, "fp8").argmax(-1)
    return {"seed": seed, "program": program,
            "control": judged(drv.gap_stats(compare.token_gaps(
                run.reference, ctrl)), run.traffic["limits"])}


def readings(cell: str, seed: int, device, config=None, traffic=None,
             control: bool = True):
    from perfbench.harness import bench
    driver = bench.workload_file(cell)["driver"]
    fn = train_readings if driver == "cpsl_train" else serve_readings
    return fn(cell, seed, device, config, traffic, control)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="",
                    help="seeds read with the control and the faults")
    ap.add_argument("--program-seeds", default="",
                    help="seeds read for the program's numbers alone")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    wrong = []
    for seeds, control in ((args.seeds, True), (args.program_seeds, False)):
        for seed in (int(s) for s in seeds.split(",") if s):
            r = readings(args.workload, seed, "cuda", control=control)
            print(json.dumps(r), flush=True)
            wrong += [f"{k} {'not ' * (k == 'program')}correct, seed {seed}"
                      for k, v in r.items() if isinstance(v, dict)
                      and "correct" in v and v["correct"] != (k == "program")]
            torch.cuda.empty_cache()
    for w in wrong:
        print(f"control: {w}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
