"""The port's kernel build keys each library by everything it compiles
from: the source, every shared header and the flags. Nothing here needs
nvcc or a card."""
import shutil

from repro_torch.kernels import _build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_every_source_and_header_is_in_the_tree():
    assert _build.sources() == ["causal_conv", "flash_attention",
                                "gated_norm", "ssd", "ssd_bwd"]
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers == ["mma.cuh", "tma.cuh"]
    for name in _build.sources():
        text = (_build.CSRC / f"{name}.cu").read_text()
        # every kernel on the tensor cores shares the wgmma helpers; the
        # two forwards also the TMA map encoder (the SSD backward loads by
        # cp.async); the gated norm and the causal conv use neither (plain
        # 16-byte loads, and the conv its own cp.async copies)
        assert ('#include "mma.cuh"' in text) == (
            name not in ("gated_norm", "causal_conv"))
        assert ('#include "tma.cuh"' in text) == (name in ("flash_attention",
                                                         "ssd"))


def test_editing_a_shared_header_changes_every_target(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: _build._target(n) for n in _build.sources()}
    header = csrc / "mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_target_is_stable_and_follows_its_own_source(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    first = {n: _build._target(n) for n in _build.sources()}
    assert first == {n: _build._target(n) for n in _build.sources()}
    src = csrc / "ssd.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target("ssd") != first["ssd"]
    assert _build._target("flash_attention") == first["flash_attention"]
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("flash_attention") != first["flash_attention"]
