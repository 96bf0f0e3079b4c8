"""Each cell's check at a small size on the CPU: a sound run is correct;
the control (the reference in fp8 in the program's place) reads well
above the program; and a run with its timed path broken underneath (the
look for a card skipped) comes out not correct, once for each fault the
cell can have. The same readings at the cells' own size are taken on the
card by ``perfbench/control.py``."""
import pytest
import torch

from conftest import SERVE, TRAIN, tiny


def _execute(cell, seed=2**31 + 11):
    from perfbench import run
    cfg, traffic = tiny(cell)
    return run.execute(cell, seed, 0.2, False, "cpu", config=cfg,
                       traffic=traffic)


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_sound_run_is_correct(cell):
    res = _execute(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_control_reads_above_the_program(cell):
    from perfbench import control
    cfg, traffic = tiny(cell)
    r = control.readings(cell, 2**31 + 21, "cpu", cfg, traffic)
    names = [n for n in r["control"] if n in r["program"] and
             n != "correct"]
    # the control fails at least one number by 3x the program's reading
    assert any(r["control"][n] >= 3 * r["program"][n] for n in names), r
    assert r["program"]["correct"]
    if cell == TRAIN:
        assert r["half_batch"]["grad_gap"] >= 10 * r["program"]["grad_gap"]
        assert not r["control"]["correct"]
        assert not r["half_batch"]["correct"]
        assert not r["loss_altered"]["correct"]


def test_control_is_judged_by_the_runs_rule():
    """``control.judged`` applies ``run.judge`` at the cell's limits: a
    reading past one limit is not correct, one within all of them is."""
    from perfbench import control
    limits = {"a": 0.1, "b": 0.01}
    assert control.judged({"a": 0.05, "b": 0.005}, limits)["correct"]
    assert not control.judged({"a": 0.05, "b": 0.02}, limits)["correct"]
    assert not control.judged({"a": float("nan"), "b": 0.0},
                              limits)["correct"]


# -- faults planted in the program's timed path -----------------------------

def _step_unchanged(monkeypatch):
    from repro_torch.core.cpsl import CPSL
    orig = CPSL.fused_step_impl

    def step(self, state, batch, lr_scale=None, fleet=False):
        _, mt = orig(self, state, batch, lr_scale, fleet)
        return state, mt
    monkeypatch.setattr(CPSL, "fused_step_impl", step)


def _half_batch(monkeypatch):
    from repro_torch import tree
    from repro_torch.core.cpsl import CPSL
    orig = CPSL._total_loss

    def loss(self, dev, srv, batch, fleet=False):
        half = tree.map(lambda t: t[:, :t.shape[1] // 2], batch)
        return orig(self, dev, srv, half, fleet)
    monkeypatch.setattr(CPSL, "_total_loss", loss)


def _loss_altered(monkeypatch):
    from repro_torch.core.cpsl import CPSL
    orig = CPSL.fused_step_impl

    def step(self, state, batch, lr_scale=None, fleet=False):
        state, mt = orig(self, state, batch, lr_scale, fleet)
        return state, dict(mt, loss=mt["loss"] * 1.01)
    monkeypatch.setattr(CPSL, "fused_step_impl", step)


def _token_altered(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine._sample
    calls = []

    def sample(logits, temperature, generator):
        tok = orig(logits, temperature, generator)
        calls.append(1)
        return (tok + 1) % logits.shape[-1] if len(calls) % 3 == 0 else tok
    monkeypatch.setattr(ServeEngine, "_sample", staticmethod(sample))


def _serve_half_batch(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine.prefill

    def prefill(self, batch):
        t = batch["tokens"]
        half = t[:t.shape[0] // 2]
        return orig(self, {"tokens": torch.cat([half, half])})
    monkeypatch.setattr(ServeEngine, "prefill", prefill)


def _step_returns_its_state(monkeypatch):
    """A decode step that computes nothing: it hands back the cache and
    the logits it was given (the prefill's)."""
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine.prefill
    last = {}

    def prefill(self, batch):
        last["logits"], cache = orig(self, batch)
        return last["logits"], cache

    def decode(self, cache, tokens, pos):
        return last["logits"], cache
    monkeypatch.setattr(ServeEngine, "prefill", prefill)
    monkeypatch.setattr(ServeEngine, "decode", decode)


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, _step_unchanged), (TRAIN, _half_batch), (TRAIN, _loss_altered),
    (SERVE, _token_altered), (SERVE, _serve_half_batch),
    (SERVE, _step_returns_its_state)])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _execute(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_cell_is_correct_on_the_card(cuda, cell):
    """A short run of each cell at its own size on the card."""
    from perfbench import run
    res = run.execute(cell, 2**31 + 99, 1.0, False, "cuda")
    assert res["correct"], res["checks"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_control_is_not_correct_on_the_card(cuda, cell):
    """The control at the cell's own size, judged by the run's rule."""
    from perfbench import control
    r = control.readings(cell, 2**31 + 97, "cuda")
    assert r["program"]["correct"], r
    assert not r["control"]["correct"], r
