"""The port's analyzers (``repro_torch.analysis``), mirroring
``tests/test_analysis.py``: each rule trips on its fixture and stays
silent on the negative control, ``src/repro_torch`` lints clean, the
dtype audit finds a planted f64 cast, and the CLI gates on the empty
baseline. The torch RNG fixtures are ``analysis_fixtures/torch_rng_*.py``;
the thread-lint fixtures are the reference's, read as they are.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch import streams
from repro_torch.analysis import jit_audit, rng_lint, run_all, thread_lint
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.report import load_baseline

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
SRC_PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
CPU = torch.device("cpu")


def _codes(findings):
    return sorted(f.code for f in findings)


# -- rng_lint -----------------------------------------------------------------

def test_rng_fixture_trips_every_rule():
    src = (FIXTURES / "torch_rng_bad.py").read_text()
    fs = rng_lint.lint_source(src, "analysis_fixtures/torch_rng_bad.py")
    assert _codes(fs) == ["RNG001", "RNG001", "RNG002", "RNG004", "RNG004",
                          "RNG004"]
    details = {f.code: f.detail for f in fs}
    assert details["RNG002"] == "key(1, 2, 3)"
    lines = [f.line for f in fs if f.code == "RNG004"]
    assert len(set(lines)) == 3       # Generator, manual_seed, .manual_seed


def test_rng_negative_control_is_clean():
    src = (FIXTURES / "torch_rng_clean.py").read_text()
    assert rng_lint.lint_source(
        src, "analysis_fixtures/torch_rng_clean.py") == []


def test_rng_streams_file_is_exempt():
    src = (FIXTURES / "torch_rng_bad.py").read_text()
    assert rng_lint.lint_source(src, "repro_torch/streams.py") == []


def test_rng004_one_finding_per_seeded_root():
    src = ("import torch\n"
           "g = torch.Generator(device='cpu').manual_seed(3)\n")
    fs = rng_lint.lint_source(src, "x.py")
    assert _codes(fs) == ["RNG004"]


def test_rng003_on_synthetic_registry_collision(monkeypatch, tmp_path):
    # a new length-2 pattern (Sym, 9967) collides with fleet_reserve_means
    bad = streams.StreamSpec(
        "bad_collider", "tuple", (streams.Sym("s"), 9967), "test-only")
    monkeypatch.setitem(streams.REGISTRY, "bad_collider", bad)
    fs = rng_lint.run(tmp_path)        # empty dir: registry check only
    assert _codes(fs) == ["RNG003"]
    assert "fleet_reserve_means" in fs[0].detail


# -- thread_lint (the reference's fixtures) -----------------------------------

def test_thr_fixture_trips_every_rule():
    src = (FIXTURES / "thr_bad.py").read_text()
    fs = thread_lint.lint_source(src, "analysis_fixtures/thr_bad.py")
    assert _codes(fs) == ["THR001", "THR002", "THR003", "THR003", "THR004"]
    details = {f.detail for f in fs}
    assert "Racy.unannotated" in details          # THR001
    assert "Racy.bad_none:none" in details        # THR003 (no reason)
    assert "Racy.bad_lock:badlock" in details     # THR003 (not a lock)
    assert any(d.startswith("Racy.locked:poke:") for d in details)    # THR002
    assert any(d.startswith("Racy.main_only:_worker:") for d in details)


def test_thr_negative_control_is_clean():
    src = (FIXTURES / "thr_clean.py").read_text()
    assert thread_lint.lint_source(src,
                                   "analysis_fixtures/thr_clean.py") == []


def test_thread_lint_run_scans_rt_dir(tmp_path):
    rt = tmp_path / "rt"
    rt.mkdir()
    (rt / "racy.py").write_text((FIXTURES / "thr_bad.py").read_text())
    assert "THR001" in _codes(thread_lint.run(tmp_path))
    assert thread_lint.run(tmp_path / "nowhere") == []


# -- the real tree lints clean ------------------------------------------------

def test_src_repro_torch_rng_lints_clean():
    assert rng_lint.run(SRC_PORT) == []


def test_src_repro_torch_thread_lints_clean():
    assert thread_lint.run(SRC_PORT) == []


# -- jit_audit ----------------------------------------------------------------

def test_jit003_finds_a_planted_f64_cast():
    x = torch.ones(3)
    fs = jit_audit.audit("c", lambda: x.double().sum(), CPU)
    assert _codes(fs) == ["JIT003"]
    # ... and the documented allowance silences it
    assert jit_audit.audit("c", lambda: x.double().sum(), CPU,
                           f64_allowance=1) == []


def test_jit003_finds_a_mixed_promotion():
    x, y = torch.ones(3), torch.ones(3, dtype=torch.float64)
    assert jit_audit.count_f64_casts(lambda: x * y) == ["aten.mul.Tensor"]
    assert jit_audit.count_f64_casts(lambda: y.sum(dtype=torch.float32))


def test_jit003_clean_target():
    x, y = torch.ones(3), torch.ones(3, dtype=torch.float64)
    assert jit_audit.audit("ok", lambda: (x * 2.0 + 1).sum(), CPU) == []
    assert jit_audit.audit("ok64", lambda: (y * 2.0).exp(), CPU) == []


def test_real_targets_audit_clean_on_cpu():
    """All four targets, run once each on the CPU (JIT003; JIT002 needs
    the card)."""
    assert jit_audit.run(device="cpu") == []


def test_audit_needs_the_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jit_audit.run(targets=("round_fused",))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: JIT002 runs the targets under "
                    "torch.cuda.set_sync_debug_mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_jit002_on_the_card(cuda):
    x = torch.ones(3, device=cuda)
    fs = jit_audit.audit("sync", lambda: float(x.sum()), cuda)
    assert _codes(fs) == ["JIT002"]
    assert jit_audit.audit("nosync", lambda: x.sum() * 2, cuda) == []
    assert jit_audit.run(device="cuda") == []


# -- CLI + baseline workflow --------------------------------------------------

def test_cli_clean_on_src_with_the_cpu_audit(tmp_path):
    out = tmp_path / "ANALYSIS.json"
    rc = analysis_main(["--check", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["n_new"] == 0 and rep["n_stale_baseline"] == 0
    assert rep["jit_checks_run"] == ["JIT003"]
    assert rep["jit_targets"] == list(jit_audit.TARGET_NAMES)
    assert set(rep["not_applicable"]) == {"JIT001", "JIT004"}


def test_cli_fails_on_new_findings(tmp_path):
    rc = analysis_main(["--check", "--no-jit", "--root", str(FIXTURES),
                        "--baseline", str(tmp_path / "missing.json")])
    assert rc == 1


def test_cli_baseline_suppresses_and_flags_stale(tmp_path):
    findings = run_all(FIXTURES, jit=False)
    assert findings, "fixtures must produce findings"
    entries = [{"key": f.key, "why": "fixture: intentional violation"}
               for f in findings]
    entries.append({"key": "THR999:gone.py:x", "why": "no longer exists"})
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps(entries))
    out = tmp_path / "ANALYSIS.json"
    rc = analysis_main(["--check", "--no-jit", "--root", str(FIXTURES),
                        "--baseline", str(bl), "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["n_new"] == 0
    assert rep["stale_baseline"] == ["THR999:gone.py:x"]


def test_cli_without_a_card_needs_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis_main(["--check"])


def test_baseline_entries_require_why(tmp_path):
    p = tmp_path / "b.json"
    p.write_text('[{"key": "RNG001:x.py:L1"}]')
    with pytest.raises(AssertionError, match="why"):
        load_baseline(p)


def test_committed_baseline_is_empty():
    committed = SRC_PORT / "analysis" / "baseline.json"
    assert json.loads(committed.read_text()) == []
