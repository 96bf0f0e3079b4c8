"""Finding model + baseline diffing for ``repro_torch.analysis`` (the
port's copy of ``repro.analysis.report``).

Every pass emits :class:`Finding` rows.  A finding's ``key`` is stable
across line-number churn (``CODE:relpath:detail``), so the committed
``baseline.json`` — a list of ``{"key", "why"}`` entries, each carrying
its per-line justification — survives unrelated edits.  ``--check``
fails on any finding whose key is not baselined, and warns about stale
baseline entries that no longer match anything.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

__all__ = ["Finding", "load_baseline", "diff_findings", "write_report"]


@dataclasses.dataclass
class Finding:
    code: str                   # e.g. "RNG002", "JIT001", "THR003"
    path: str                   # repo-relative file (or audit target name)
    line: int                   # 1-based; 0 when not line-addressable
    message: str
    detail: str = ""            # stable discriminator within (code, path)

    @property
    def key(self) -> str:
        return f"{self.code}:{self.path}:{self.detail}"

    def to_dict(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def load_baseline(path) -> List[dict]:
    """Baseline file: ``[{"key": ..., "why": ...}, ...]``.  Every entry
    MUST carry a non-empty ``why`` — the per-line justification the
    acceptance contract asks for."""
    path = Path(path)
    if not path.exists():
        return []
    entries = json.loads(path.read_text())
    assert isinstance(entries, list), "baseline.json must be a list"
    for e in entries:
        assert isinstance(e, dict) and e.get("key") and e.get("why"), \
            f"baseline entry needs non-empty 'key' and 'why': {e!r}"
    return entries


def diff_findings(findings: List[Finding], baseline: List[dict]):
    """Returns (new, stale): findings not covered by the baseline, and
    baseline entries matching no current finding."""
    keys = {f.key for f in findings}
    base_keys = {e["key"] for e in baseline}
    new = [f for f in findings if f.key not in base_keys]
    stale = [e for e in baseline if e["key"] not in keys]
    return new, stale


def write_report(findings: List[Finding], new: List[Finding],
                 stale: List[dict], out: Optional[str],
                 notes: Optional[dict] = None) -> dict:
    """The report dict (written to ``out`` when given); ``notes`` adds
    keys beside the findings (the program audit's scope)."""
    report = {
        "n_findings": len(findings),
        "n_new": len(new),
        "n_stale_baseline": len(stale),
        "findings": [f.to_dict() for f in findings],
        "new": [f.key for f in new],
        "stale_baseline": [e["key"] for e in stale],
        **(notes or {}),
    }
    if out:
        Path(out).write_text(json.dumps(report, indent=2) + "\n")
    return report
