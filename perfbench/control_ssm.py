"""The controls of the serving cells with Mamba-2 layers
(``drivers/serve_ssm.py``) and the faults their check must catch, read on
the card at the cell's own size (or, from the tests, at a small size on
the CPU).

    python3 perfbench/control_ssm.py --workload <cell> --seeds 11,12,13 \
        [--program-seeds 14,15,...]

``control.py`` judges the token check alone; this reads both numbers the
driver compares, ``mean_token_gap`` and ``logit_gap``. For every seed of
``--seeds`` the program runs as ``control.py`` runs it (set-up, two
generate calls, the check), then in its place:

- the control: the reference computed in fp8 (``reference.precision``),
  its logits as the served logits and its first tokens as the served
  tokens;
- each fault of ``FAULTS`` that the cell's model has, planted in the
  program, which then runs again as it did.

Each reading is judged as a run judges the program (``run.judge``, at the
cell's ``limits`` and ``logit_limits``): one JSON line a seed. The exit
code is 1 where the control or a fault came out correct, or the program
did not.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


@contextlib.contextmanager
def ssm_state_unwritten():
    """A decode step that computes from the SSM state but leaves it as the
    prefill wrote it."""
    from repro_torch.models import mamba2
    step = mamba2.mamba_decode_step

    def unwritten(p, x, cache, cfg):
        kept = cache["ssm"].clone()
        out, cache = step(p, x, cache, cfg)
        cache["ssm"].copy_(kept)
        return out, cache
    with mock.patch.object(mamba2, "mamba_decode_step", unwritten):
        yield


def _engine_config(change):
    """The served model's configuration changed by ``change`` as the engine
    is built."""
    from repro_torch.serving.engine import ServeEngine
    init = ServeEngine.__init__

    def make(self, cfg, *a, **k):
        init(self, change(cfg), *a, **k)
    return mock.patch.object(ServeEngine, "__init__", make)


def rope_applied():
    """The rotary embedding on granite's attention (the config's NoPE
    ignored)."""
    return _engine_config(lambda cfg: cfg.replace(rope=True))


def residual_dropped():
    """Each sublayer's output added without granite's residual
    multiplier."""
    return _engine_config(lambda cfg: cfg.replace(mup=dataclasses.replace(
        cfg.mup, residual_multiplier=1.0)))


# each fault, and the model types whose program it reaches
FAULTS = {"ssm_state_unwritten": (ssm_state_unwritten,
                                  ("mamba2", "granitemoehybrid")),
          "rope_applied": (rope_applied, ("granitemoehybrid",)),
          "residual_dropped": (residual_dropped, ("granitemoehybrid",))}


def faults_of(cfg: dict) -> list:
    return [n for n, (_, types) in FAULTS.items()
            if cfg["model_type"] in types]


def limits(traffic: dict) -> dict:
    return dict(traffic["limits"], **traffic["logit_limits"])


def program(cell: str, seed: int, device, config=None, traffic=None,
            fault: str = None):
    """The program's run and its driver after the check, with ``fault``
    planted."""
    from perfbench import control
    from perfbench.run import judge
    run, drv = control._run(cell, seed, device, config, traffic)
    with (FAULTS[fault][0]() if fault else contextlib.nullcontext()):
        drv.prepare(run)
        run.min_calls = 2
        drv.window(run)
        run.correct = judge(drv.verify(run))
    return run, drv


def control_readings(run, drv) -> dict:
    """The fp8 reference's logits and first tokens in the program's
    place."""
    from perfbench.reference import compare
    ctrl = drv.reference_logits(run, run.seqs, "fp8")
    got = drv.gap_stats(compare.token_gaps(run.reference, ctrl.argmax(-1)))
    gaps = drv.logit_gaps(ctrl, run.reference)
    return dict(got, logit_gap=float(gaps.mean()),
                widest_logit_gap=float(gaps.max()))


def readings(cell: str, seed: int, device, config=None, traffic=None,
             control: bool = True, faults=None) -> dict:
    """One seed's readings, each with its ``correct``. ``faults`` (default:
    every fault the cell's model has) are planted only with ``control``."""
    from perfbench import control as ctl
    run, drv = program(cell, seed, device, config, traffic)
    out = {"seed": seed, "program": dict(run.readings, correct=run.correct)}
    if not control:
        return out
    lim = limits(run.traffic)
    out["control"] = ctl.judged(control_readings(run, drv), lim)
    cfg = run.cfg
    del run
    for fault in faults_of(cfg) if faults is None else faults:
        frun, _ = program(cell, seed, device, config, traffic, fault)
        out[fault] = ctl.judged(frun.readings, lim)
        del frun
    return out


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
        print("control_ssm: no CUDA card", file=sys.stderr)
        return 2
    wrong = []
    for seeds, control in ((args.seeds, True), (args.program_seeds, False)):
        for seed in (int(s) for s in seeds.split(",") if s):
            r = readings(args.workload, seed, "cuda", control=control)
            print(json.dumps(r), flush=True)
            wrong += [f"{k} {'not ' * (k == 'program')}correct, seed {seed}"
                      for k, v in r.items() if isinstance(v, dict)
                      and v["correct"] != (k == "program")]
            torch.cuda.empty_cache()
    for w in wrong:
        print(f"control_ssm: {w}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
