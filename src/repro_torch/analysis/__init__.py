"""repro_torch.analysis — contract linters and program audits gating the
port's bit-exactness invariants (the port of ``repro.analysis``).

Three passes, one entry point (``python -m repro_torch.analysis
--check``):

  * :mod:`repro_torch.analysis.rng_lint`    — every RNG construction in
    ``src/repro_torch`` goes through the :mod:`repro_torch.streams`
    registry (RNG00x);
  * :mod:`repro_torch.analysis.jit_audit`   — host-sync freedom (on the
    card) and dtype discipline of the flagship programs (JIT002, JIT003;
    JIT001 and JIT004 have no eager counterpart and are reported as not
    applicable);
  * :mod:`repro_torch.analysis.thread_lint` — the ``rt/`` runtime's
    ``# guarded-by`` lock-annotation discipline (THR00x).

Findings diff against the committed ``analysis/baseline.json``; the
check fails on any finding not baselined with a justification.
"""

from repro_torch.analysis.report import (Finding, diff_findings,
                                         load_baseline, write_report)

__all__ = ["Finding", "diff_findings", "load_baseline", "write_report",
           "run_all"]


def run_all(root, jit: bool = True, jit_targets=None, device="cuda"):
    """Run every pass over ``root`` (the ``src/repro_torch`` directory);
    the jit audit runs on ``device`` (``cuda`` unless the caller asks for
    ``cpu``). Returns the combined finding list."""
    from repro_torch.analysis import jit_audit, rng_lint, thread_lint
    findings = []
    findings += rng_lint.run(root)
    findings += thread_lint.run(root)
    if jit:
        findings += jit_audit.run(
            root, targets=jit_targets or jit_audit.TARGET_NAMES,
            device=device)
    return findings
