"""The yardstick's arithmetic against hand counts, and the frozen
model-FLOPs copy against the program's own ``launch/roofline.py``."""
import pytest

from perfbench.harness import work


def test_causal_pairs():
    assert work.causal_pairs(4, 4) == 1 + 2 + 3 + 4
    assert work.causal_pairs(2, 5) == 4 + 5


def test_flash_attention_work_by_hand():
    # q (2 heads, 3, 8), k and v (2, 3, 8) and (2, 3, 4) in bf16
    ops = [((2, 3, 8), 2), ((2, 3, 8), 2), ((2, 3, 4), 2)]
    res = [((2, 3, 4), 2)]
    flops, nbytes = work.flash_attention_work(ops, res)
    assert flops == 2 * (8 + 4) * 6 * 2
    assert nbytes == 2 * (48 + 48 + 24 + 24)
    flops, _ = work.flash_attention_work(ops, res, causal=False)
    assert flops == 2 * (8 + 4) * 9 * 2
    # v and the output padded from 2 to 4 columns: the padding is no work
    flops, nbytes = work.flash_attention_work(ops, res, dv=2)
    assert flops == 2 * (8 + 2) * 6 * 2
    assert nbytes == 2 * (48 + 48 + 12 + 12)


def test_ssd_work_by_hand():
    b, s, h, p, g, n = 1, 8, 2, 4, 1, 2
    ops = [((b, s, h, p), 2), ((b, s, h), 4), ((h,), 4), ((b, s, g, n), 2),
           ((b, s, g, n), 2)]
    res = [((b, s, h, p), 2), ((b, h, n, p), 4)]
    flops, nbytes = work.ssd_work(ops, res, chunk=4)
    pairs = 4 * 5 // 2
    assert flops == b * g * 2 * 2 * pairs * n + b * h * 2 * (
        2 * pairs * p + 4 * 4 * n * p)
    assert nbytes == 2 * 64 + 4 * 16 + 4 * 2 + 2 * 16 * 2 + 2 * 64 + 4 * 16
    assert work.chunk_len(8191, 256) == 1 and work.chunk_len(24, 16) == 8


def test_model_flops_by_hand():
    cfg = {"model_type": "mamba2", "hidden_size": 4, "num_hidden_layers": 2,
           "vocab_size": 10, "expand": 2, "head_dim": 2, "n_groups": 1,
           "state_size": 3}
    # per layer: d (2 d_inner + 2 g n + heads) + d_inner d
    n = 2 * (4 * (16 + 6 + 4) + 8 * 4) + 4 * 10
    assert work.active_matmul_params(cfg) == n
    state = 2 * 4 * 4 * 3 * 2
    assert work.model_flops(cfg, "train", 2, 5) == 6 * n * 10 + 3 * state * 10
    assert work.model_flops(cfg, "prefill", 2, 5) == 2 * n * 10 + state * 10


@pytest.mark.parametrize("cell,kind", [
    ("mamba2-2.7b.cpsl-train", "train"),
    ("deepseek-v2-lite-16b.serve", "prefill")])
def test_model_flops_equals_the_programs(cell, kind):
    from perfbench.harness import bench
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import roofline
    man = bench.manifest()
    cfg = bench.config_file(man, bench.cell(man, cell)["config"])
    pcfg = bench.load_module(
        "drivers", bench.workload_file(cell)["driver"]).port_config(cfg)
    shape = ShapeCfg("x", 4096, 8, kind)
    assert work.model_flops(cfg, kind, 8, 4096) == pytest.approx(
        roofline.model_flops(pcfg, shape), rel=1e-12)
