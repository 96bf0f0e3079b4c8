"""Program-contract audit of the port's flagship programs (the port of
``repro.analysis.jit_audit``).

The reference traces its jitted programs and checks four contracts on the
jaxpr. Eager PyTorch has no jaxpr: the port runs each target once on tiny
shapes and checks the contracts that carry over, by meaning:

  JIT002  host-sync-free: the target runs on the card under
          ``torch.cuda.set_sync_debug_mode("error")``, which raises at
          any host-device synchronisation (a ``.item()``, a ``float()``
          of a device tensor, a copy to the host, a blocking copy from
          pageable memory). Any sync is a finding. Needs the card.
  JIT003  no implicit f32<->f64 casts beyond the target's allowance (0
          everywhere, as in the reference): a dispatch mode counts the
          ops that turn float32 into float64 or back inside the target —
          a cast (``_to_copy``, ``copy_`` across the two types), an op
          whose inputs mix the two, or an op whose float inputs are one
          and whose result the other. The CPSL programs are pure f32;
          the simulator is pure f64, its inputs cast at the host boundary
          (``SimFleetRunner.sim_inputs``) before the mode is entered.
          Runs on the card or, with ``device="cpu"``, on the CPU.

Not applicable, reported as such and never a finding:

  JIT001  donation: PyTorch has no ``donate_argnums``; an eager step
          hands back new tensors and the caller drops the old ones.
  JIT004  weak-typed carries: eager loops carry tensors whose dtype is
          fixed when they are made; no trace is re-specialised when a
          caller passes a strongly typed value.

The reference's recompile guard (``cache_size``, ``CompileCounter``,
used by ``benchmarks/bench_fleet.py``) has nothing to count here: eager
PyTorch compiles nothing, so the port has no counterpart.

Audited targets (the reference's acceptance set, on its tiny settings):

  * ``CPSL.run_round_fused``      — one round;
  * ``CPSL.run_training_fused``   — the R-round curve;
  * ``CPSL.run_fleet``            — E batched curves;
  * ``SimFleetRunner.run``'s program (``sim.fleet._simulate``) — the
    two-timescale Monte-Carlo simulator in float64.
"""

from __future__ import annotations

import traceback
from pathlib import Path
from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.analysis.report import Finding

__all__ = ["run", "audit", "count_f64_casts", "F64Casts", "TARGET_NAMES",
           "NOT_APPLICABLE"]

TARGET_NAMES = ("round_fused", "training_fused", "fleet", "fleet_sim")

NOT_APPLICABLE = {
    "JIT001": "donation: PyTorch has no donate_argnums; an eager step "
              "returns new tensors and the caller drops the old ones",
    "JIT004": "weak-typed carries: eager loops carry tensors whose dtype "
              "is fixed when made; nothing is traced, so nothing retraces",
}

_F32_F64 = {torch.float32, torch.float64}


class F64Casts(TorchDispatchMode):
    """Counts the ops that turn float32 into float64 or back."""

    def __init__(self):
        super().__init__()
        self.casts: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        floats_in = {t.dtype for t in _tensors((args, kwargs))
                     if t.dtype in _F32_F64}
        floats_out = {t.dtype for t in _tensors(out)
                      if t.dtype in _F32_F64}
        if floats_in == _F32_F64 or (floats_in and floats_out
                                     and floats_in != floats_out):
            self.casts.append(str(func))
        return out


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def count_f64_casts(fn: Callable) -> List[str]:
    """The f32<->f64 ops of one call of ``fn()``."""
    with F64Casts() as mode:
        fn()
    return mode.casts


def host_syncs(fn: Callable) -> List[str]:
    """Run ``fn()`` on the card under ``set_sync_debug_mode("error")``;
    returns the error of the first host sync, or [] when there is none."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        where = [f"{Path(fr.filename).name}:{fr.lineno}"
                 for fr in traceback.extract_tb(e.__traceback__)
                 if "repro_torch" in fr.filename]
        return [str(e).splitlines()[0]
                + (f" (at {where[-1]})" if where else "")]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return []


def audit(name: str, fn: Callable, device: torch.device,
          f64_allowance: int = 0) -> List[Finding]:
    """JIT002 (on the card) and JIT003 on one target: ``fn()`` runs it
    once on inputs already on ``device``."""
    findings: List[Finding] = []
    if device.type == "cuda":
        for err in host_syncs(fn):
            findings.append(Finding(
                "JIT002", name, 0,
                f"host sync inside a contractually host-sync-free "
                f"program: {err}", detail="sync"))
    casts = count_f64_casts(fn)
    if len(casts) > f64_allowance:
        findings.append(Finding(
            "JIT003", name, 0,
            f"{len(casts)} implicit f64<->f32 ops ({sorted(set(casts))}; "
            f"documented allowance: {f64_allowance})",
            detail=f"casts>{f64_allowance}"))
    return findings


# -- targets (tiny shapes; inputs built on the device before the checks) ----

def _tiny_cpsl(device):
    import numpy as np
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.splitting import make_split_model
    from repro_torch.data.pipeline import CPSLDataset, DeviceResidentDataset
    from repro_torch.data.synthetic import non_iid_split, synthetic_mnist

    M, K, B = 2, 3, 4
    clusters = [[0, 1, 2], [3, 4, 5]]
    xtr, ytr, _, _ = synthetic_mnist(400, 50, seed=0)
    idx = non_iid_split(ytr, n_devices=6, samples_per_device=60, seed=0)
    ds = CPSLDataset(xtr, ytr, idx, batch=B)
    dsd = DeviceResidentDataset.from_dataset(ds, device=device)
    ccfg = CPSLConfig(cut_layer=2, n_clusters=M, cluster_size=K,
                      local_epochs=2, batch_per_device=B,
                      unroll_clients=True)
    cp = CPSL(make_split_model("lenet", ccfg.cut_layer), ccfg)
    w = torch.as_tensor(np.asarray(dsd.cluster_weights(clusters),
                                   np.float32), device=device)
    return cp, dsd, clusters, w


def _round_fused(device):
    from repro_torch import streams
    cp, dsd, clusters, w = _tiny_cpsl(device)
    st = cp.init_state(streams.model_generator(0, device))
    idx = torch.as_tensor(dsd.round_index_table(
        clusters, 0, 0, cp.ccfg.local_epochs), device=device)
    return lambda: cp.run_round_fused(st, dsd.data, idx, w)


def _curve_index(cp, dsd, clusters, R):
    import numpy as np
    return np.stack([dsd.round_index_table(clusters, 0, r,
                                           cp.ccfg.local_epochs)
                     for r in range(R)])


def _training_fused(device):
    from repro_torch import streams
    cp, dsd, clusters, w = _tiny_cpsl(device)
    st = cp.init_state(streams.model_generator(0, device))
    idx = torch.as_tensor(_curve_index(cp, dsd, clusters, 2), device=device)
    return lambda: cp.run_training_fused(st, dsd.data, idx, w)


def _fleet(device):
    import numpy as np
    cp, dsd, clusters, w = _tiny_cpsl(device)
    E = 2
    states = cp.init_fleet_state([0, 1], device)
    idx1 = _curve_index(cp, dsd, clusters, 2)
    idx = torch.as_tensor(np.stack([idx1] * E), device=device)
    we = torch.stack([w] * E)
    return lambda: cp.run_fleet(states, dsd.data, idx, we)


def _fleet_sim(device):
    from repro_torch.configs.base import SimFleetCfg
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.profile import lenet_profile
    from repro_torch.sim.dynamics import DynamicsCfg
    from repro_torch.sim.fleet import SimFleetRunner, _simulate

    ncfg = NetworkCfg(n_devices=8, n_subcarriers=12)
    dcfg = DynamicsCfg(rho_snr=0.9, rho_f=0.95, seed=0)
    fcfg = SimFleetCfg(rounds=5, seeds=(0, 1),
                       policies=("equal", "greedy"), cluster_sizes=(3,),
                       cuts=(2, 3), batch_per_device=16, local_epochs=1)
    runner = SimFleetRunner(lenet_profile(), ncfg, dcfg, fcfg,
                            device=device)
    inputs = runner.sim_inputs()        # the host boundary: f64 uploads
    return lambda: _simulate(inputs, **runner._sim_kw)


_TARGETS = {
    "round_fused": ("CPSL.run_round_fused", _round_fused),
    "training_fused": ("CPSL.run_training_fused", _training_fused),
    "fleet": ("CPSL.run_fleet", _fleet),
    "fleet_sim": ("SimFleetRunner.run", _fleet_sim),
}


def run(root=None, targets=TARGET_NAMES, device="cuda") -> List[Finding]:
    """Audit the named targets on ``device`` (``cuda`` unless the caller
    asks for ``cpu``, where JIT002 cannot run; no CUDA raises). ``root``
    is accepted for interface symmetry with the AST passes and ignored:
    targets are imported."""
    dev = resolve_device(device)
    findings: List[Finding] = []
    for name in targets:
        label, build = _TARGETS[name]
        fn = build(dev)
        findings.extend(audit(label, fn, dev))
    return findings
