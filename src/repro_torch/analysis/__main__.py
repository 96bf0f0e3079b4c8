"""CLI: ``python -m repro_torch.analysis --check [--root src/repro_torch]
[--baseline .../baseline.json] [--out ANALYSIS.json] [--no-jit]
[--device cuda|cpu]``.

Exit 0 when every finding is baselined (with a justification); exit 1 on
any new finding. Always writes the full report to ``--out`` when given,
with the jit checks that do not apply to eager PyTorch and why.
The jit audit runs on the card unless ``--device cpu`` is given (then
JIT002, the host-sync check, cannot run); without a card and without
that flag it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import (diff_findings, load_baseline, run_all,
                                  write_report)

_HERE = Path(__file__).resolve().parent
_DEFAULT_ROOT = _HERE.parent                   # src/repro_torch
_DEFAULT_BASELINE = _HERE / "baseline.json"


def main(argv=None) -> int:
    from repro_torch.analysis import jit_audit

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--check", action="store_true",
                    help="run all passes and fail on non-baselined "
                         "findings")
    ap.add_argument("--root", default=str(_DEFAULT_ROOT),
                    help="source root to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(_DEFAULT_BASELINE),
                    help="baseline.json of justified findings")
    ap.add_argument("--out", default=None,
                    help="write the full JSON report here")
    ap.add_argument("--no-jit", action="store_true",
                    help="skip the program audit (AST passes only)")
    ap.add_argument("--device", default="cuda",
                    help="where the program audit runs (cuda or cpu; "
                         "JIT002 needs the card)")
    args = ap.parse_args(argv)
    if not args.check:
        ap.error("nothing to do: pass --check")

    findings = run_all(args.root, jit=not args.no_jit, device=args.device)
    baseline = load_baseline(args.baseline)
    new, stale = diff_findings(findings, baseline)
    notes = {}
    if not args.no_jit:
        notes = {"jit_targets": list(jit_audit.TARGET_NAMES),
                 "jit_device": args.device,
                 "jit_checks_run": (["JIT002", "JIT003"]
                                    if args.device.startswith("cuda")
                                    else ["JIT003"]),
                 "not_applicable": jit_audit.NOT_APPLICABLE}
    write_report(findings, new, stale, args.out, notes)

    for f in findings:
        mark = "NEW " if f in new else "base"
        print(f"[{mark}] {f}")
    for e in stale:
        print(f"[stale baseline] {e['key']} — {e['why']}")
    for code, why in notes.get("not_applicable", {}).items():
        print(f"[n/a] {code}: {why}")
    print(f"{len(findings)} finding(s), {len(new)} new, "
          f"{len(stale)} stale baseline entr(ies)")
    if new:
        print("FAIL: non-baselined findings — fix them or baseline each "
              "key with a 'why' in", args.baseline, file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
