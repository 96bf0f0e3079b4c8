"""The serving cells of models with Mamba-2 layers (``drivers/serve_ssm.py``)
at a small size on the CPU: a sound run is correct, the fp8 control reads
well above the program, and faults planted in the program's timed path
(``control_ssm.FAULTS``) come out not correct. Also the program's weights
against the reference's, the granite configuration file against the
program's registry model, the FLOP count against the program's own, and
the mixers' span readers."""
from types import SimpleNamespace

import pytest
import torch

from conftest import _files
from perfbench.harness import bench

MAMBA, GRANITE = "mamba2-2.7b.serve", "granite-4.0-h-small.serve"
SEED = 2**31 + 11


def tiny(cell):
    """(configuration, traffic) of ``cell`` at a size the CPU runs in
    seconds: every width cut, every mechanism kept. Granite keeps one whole
    period of 10 (attention at offset 5), its multipliers, NoPE, 8 experts
    top-2 beside a shared MLP wider than one expert, and the MoE's capacity
    drops (4 x 1040 prompt tokens pass the program's 4096); the mamba2
    prompt is no multiple of the chunk. 32 new tokens a request. The
    limits are set as the cells' are, between the program's readings and
    the fp8 control's at this size (4 seeds, ``control_ssm``)."""
    cfg, traffic = _files(cell)
    if cell == MAMBA:
        cfg.update(hidden_size=64, num_hidden_layers=3, vocab_size=211,
                   state_size=16, head_dim=16, chunk_size=8)
        # logit_gap: program 0.0118 - 0.0133, fp8 control 0.130 - 0.136
        traffic.update(prompt=37, new_tokens=32, itl_block_steps=2,
                       logit_limits={"logit_gap": 0.05})
    else:
        cfg.update(hidden_size=64, num_hidden_layers=10,
                   layer_types=cfg["layer_types"][:10], vocab_size=211,
                   num_attention_heads=4, num_key_value_heads=2,
                   mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
                   mamba_chunk_size=8, num_local_experts=8,
                   num_experts_per_tok=2, intermediate_size=32,
                   shared_intermediate_size=48, moe_group_size=16)
        # the limit set as the cell's is, between the program's readings
        # and the fp8 control's at this size (2.5e-5 to 3.5e-5 and 2.4e-4
        # to 2.8e-4 over 4 seeds): its logits are 8x narrower than the
        # cell's, whose limit is 1e-3
        # logit_gap: program 0.078 - 0.084, fp8 control 0.487 - 0.528
        traffic.update(batch=4, prompt=1040, new_tokens=32,
                       limits={"mean_token_gap": 1e-4},
                       logit_limits={"logit_gap": 0.2})
    return cfg, traffic


def _execute(cell, seed=SEED):
    from perfbench import run
    cfg, traffic = tiny(cell)
    return run.execute(cell, seed, 0.2, False, "cpu", config=cfg,
                       traffic=traffic)


@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_sound_run_is_correct(cell):
    res = _execute(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "ttft_ms"}


@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_control_reads_above_the_program(cell):
    from perfbench import control
    cfg, traffic = tiny(cell)
    r = control.readings(cell, 2**31 + 21, "cpu", cfg, traffic)
    assert r["program"]["correct"], r
    assert r["control"]["mean_token_gap"] >= \
        3 * r["program"]["mean_token_gap"], r


@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_logit_control_reads_above_the_program(cell):
    """The fp8 reference's logits read at least 3x the program's gap."""
    from perfbench import control_ssm
    cfg, traffic = tiny(cell)
    r = control_ssm.readings(cell, 2**31 + 21, "cpu", cfg, traffic,
                             faults=())
    assert r["program"]["correct"], r
    assert r["control"]["logit_gap"] >= \
        3 * r["program"]["logit_gap"], r
    assert not r["control"]["correct"], r


# -- faults planted in the program's timed path -----------------------------

@pytest.mark.parametrize("cell,fault", [
    (MAMBA, "ssm_state_unwritten"), (GRANITE, "ssm_state_unwritten"),
    (GRANITE, "rope_applied"), (GRANITE, "residual_dropped")])
def test_broken_timed_path_is_not_correct(cell, fault):
    from perfbench import control_ssm
    cfg, traffic = tiny(cell)
    assert fault in control_ssm.faults_of(cfg)
    with control_ssm.FAULTS[fault][0]():
        res = _execute(cell)
    assert not res["correct"], res["checks"]


def test_faults_reach_only_their_models():
    from perfbench import control_ssm
    assert control_ssm.faults_of(tiny(MAMBA)[0]) == ["ssm_state_unwritten"]
    assert control_ssm.faults_of(tiny(GRANITE)[0]) == [
        "ssm_state_unwritten", "rope_applied", "residual_dropped"]


# -- the weights ------------------------------------------------------------

@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_program_weights_are_the_references(cell):
    """Each layer weight the reference draws, the scaled ones among them,
    holds the reference's values in the program's tree."""
    from repro_torch import tree as tr
    drv = bench.load_module("drivers", "serve_ssm")
    cfg, _ = tiny(cell)
    ref = drv.REFERENCES[cfg["model_type"]]
    run = SimpleNamespace(seed=SEED, device=torch.device("cpu"), cfg=cfg)
    pcfg = drv.port_config(cfg)
    tree = drv.params(run, pcfg)
    period = len(pcfg.pattern)
    seen = set()
    for path, leaf in tr.flatten_with_path(tree):
        if path[0] != "stack":
            continue
        name = "/".join(str(p) for p in path[2:])
        for n in range(leaf.shape[0]):
            layer = n * period + path[1]
            want = ref.layer_params(cfg, SEED, layer, "cpu").get(name)
            if want is not None:
                seen.add(name)
                assert torch.equal(leaf[n].float(), want), (layer, name)
    assert set(ref.scales(cfg)) <= seen


# -- the configuration, the FLOP count, the readers --------------------------

def test_granite_file_is_the_registry_model():
    """``serve_ssm.port_config`` of the file is the program's registry
    model cut to the file's 20 layers (two whole periods), with only the
    run's options changed."""
    from repro_torch.configs import registry
    cfg, _ = _files(GRANITE)
    drv = bench.load_module("drivers", "serve_ssm")
    got = drv.port_config(cfg)
    base = registry.get("granite-4.0-h-small")
    assert got == base.replace(n_layers=20)
    assert got.n_periods == 2
    assert [s.mixer for s in got.layer_specs()] == [
        "attn" if t == "attention" else "mamba" for t in cfg["layer_types"]]


def test_mamba2_file_is_the_train_cells_model():
    cfg, _ = _files(MAMBA)
    drv = bench.load_module("drivers", "serve_ssm")
    train = bench.load_module("drivers", "cpsl_train")
    assert drv.port_config(cfg) == train.port_config(cfg)


@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_model_flops_equals_the_programs(cell):
    from perfbench.harness import hybrid_work
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import roofline
    cfg, _ = _files(cell)
    pcfg = bench.load_module("drivers", "serve_ssm").port_config(cfg)
    assert hybrid_work.model_flops(cfg, 8, 4096) == pytest.approx(
        roofline.model_flops(pcfg, ShapeCfg("x", 4096, 8, "prefill")),
        rel=1e-12)


def test_granite_active_params_by_hand():
    """The 20 layers the cell runs: 18 Mamba-2 layers of 102.24 M, 2 GQA
    layers of 41.94 M, 20 MoE layers of 10 x 9.44 M experts and an 18.87 M
    shared MLP, and the 411 M tied head: 4.60 B."""
    from perfbench.harness import hybrid_work
    cfg, _ = _files(GRANITE)
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096
    moe = 3 * 4096 * (768 * 10 + 1536)
    want = 18 * mamba + 2 * attn + 20 * moe + 4096 * 100352
    assert hybrid_work.active_matmul_params(cfg) == want
    assert round(want / 1e9, 2) == 4.60


class _Span:
    def __init__(self, name, i, parent, secs):
        self.name, self.id, self.parent, self.seconds = name, i, parent, secs


@pytest.mark.parametrize("name,phase,span", [
    ("mamba_pct.prefill", "serve.prefill", "mamba"),
    ("attn_pct.prefill", "serve.prefill", "attn")])
def test_mixer_readers(monkeypatch, name, phase, span):
    from repro_torch import telemetry
    rec = bench.Record({}, {})
    read = bench.load_module("metrics", name).read
    other = "serve.decode"
    spans = [_Span("serve.generate", 0, None, 10.0),
             _Span(phase, 1, 0, 4.0), _Span(span, 2, 1, 1.0),
             _Span("moe", 3, 1, 2.0), _Span(other, 4, 0, 5.0),
             _Span(span, 5, 4, 3.0)]
    monkeypatch.setattr(telemetry, "spans", lambda: list(spans))
    assert read(rec) == pytest.approx(25.0)
    # a program without the mixers' spans (the parent's): no reading
    monkeypatch.setattr(telemetry, "spans",
                        lambda: [s for s in spans if s.name != span])
    assert read(rec) is None
    monkeypatch.delattr(telemetry, "spans")
    assert read(rec) is None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [MAMBA, GRANITE])
def test_cell_is_correct_on_the_card(cuda, cell):
    """A short run of each cell at its own size on the card."""
    from perfbench import run
    res = run.execute(cell, 2**31 + 99, 1.0, False, "cuda")
    assert res["correct"], res["checks"]

