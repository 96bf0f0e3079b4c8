"""A measurement with no card fails: exit code 2, no result line, and no
fall-back to the CPU. So does a checkout holding only BENCHMARK.json and
the benchmark's folder."""
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TRAIN


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(run, "execute", lambda *a, **k: called.append(1))
    rc = run.main(["--workload", TRAIN, "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and not called
    assert out.out == ""
    assert "CUDA" in out.err


def test_program_device_refuses_the_cpu():
    """The program's own entry points raise for a CUDA device without
    CUDA; the harness hands them the card's device only."""
    import torch
    from repro_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_bare_checkout_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", TRAIN, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
