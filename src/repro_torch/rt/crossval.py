"""Sim-vs-runtime cross-validation: predicted vs measured round latency
(the port of ``repro.rt.crossval``).

A loopback trace carries, per executed round, both the eq. 15-25 cost
model's prediction for the executed plan (``latency_s`` /
``planned_latency_s``, re-derivable from the recorded ``v / clusters /
xs / f / rate`` snapshot via ``sim.engine.recompute_trace_latencies``)
and the measured wall-clock (``wall_s``). This module joins the two per
round — the fidelity check the paper's simulation results implicitly
assume: does the deployed runtime's timing track the analytical model?

On plain loopback the measured times are dominated by real compute +
localhost I/O, so the interesting column is the *ratio's stability*
across rounds; with ``RTConfig.delay_scale`` the priced wireless delays
are physically injected and measured/predicted converge toward the
scale factor.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def crossval_rows(records, prof=None, ncfg=None, B: Optional[int] = None,
                  L: Optional[int] = None) -> List[dict]:
    """Per-round {round, predicted_s, measured_s, ratio} rows from a
    trace. Predictions prefer a fresh reprice of the recorded snapshot
    (when ``prof``/``ncfg``/``B``/``L`` are given) over the recorded
    ``latency_s`` / ``planned_latency_s``."""
    from repro_torch.rt.qos import round_wall_clocks

    measured = round_wall_clocks(records)
    predicted = {}
    # rounds recompute_trace_latencies would price, in its order
    priceable = [rec for rec in records
                 if not rec.get("skipped") and "v" in rec]
    for rec in priceable:
        lat = rec.get("latency_s", rec.get("planned_latency_s"))
        if lat is not None:
            predicted[int(rec["round"])] = float(lat)
    if prof is not None and ncfg is not None:
        from repro_torch.sim.engine import recompute_trace_latencies
        lats = recompute_trace_latencies(records, prof, ncfg, B, L)
        for rec, lat in zip(priceable, lats):
            predicted[int(rec["round"])] = float(lat)

    rows = []
    for rnd in sorted(set(measured) & set(predicted)):
        p, m = predicted[rnd], measured[rnd]
        rows.append({"round": rnd, "predicted_s": p, "measured_s": m,
                     "ratio": (m / p if p > 0 else float("inf"))})
    return rows


def summarize(rows: List[dict]) -> dict:
    """Aggregate fidelity stats over the joined rounds."""
    if not rows:
        return {"n_rounds": 0}
    ratios = np.array([r["ratio"] for r in rows], np.float64)
    return {"n_rounds": len(rows),
            "predicted_total_s": float(sum(r["predicted_s"] for r in rows)),
            "measured_total_s": float(sum(r["measured_s"] for r in rows)),
            "ratio_mean": float(ratios.mean()),
            "ratio_min": float(ratios.min()),
            "ratio_max": float(ratios.max()),
            # relative spread of the per-round ratio: how *stable* the
            # model's (scaled) prediction is across rounds
            "ratio_rel_spread": float(
                (ratios.max() - ratios.min()) / max(ratios.mean(), 1e-12))}


def crossval_report(records, prof=None, ncfg=None,
                    B: Optional[int] = None, L: Optional[int] = None,
                    path: Optional[str] = None) -> dict:
    """{rows, summary}; optionally written to ``path`` as JSON (the
    loopback example writes this artifact)."""
    rows = crossval_rows(records, prof, ncfg, B, L)
    report = {"rows": rows, "summary": summarize(rows)}
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
    return report
