"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the checkout (the card's tests: add ``-m requires_cuda``)."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

TRAIN, SERVE = "mamba2-2.7b.cpsl-train", "deepseek-v2-lite-16b.serve"


def _files(cell):
    from perfbench.harness import bench
    man = bench.manifest()
    wl = bench.workload_file(cell)
    return (bench.config_file(man, bench.cell(man, cell)["config"]),
            copy.deepcopy(wl["params"]))


def tiny(cell):
    """(configuration, traffic) of ``cell`` at a size the CPU runs in
    seconds: every width cut, every mechanism kept (the MoE's capacity
    drops included: 4 x 1040 prompt tokens pass the program's 4096). The
    training cell computes in float32 here: at a width of 64, bf16's
    rounding moves the first gradient's worst leaf to about the cell's
    limit, which is set from the readings at the cell's own widths."""
    cfg, traffic = _files(cell)
    if cell == TRAIN:
        cfg.update(hidden_size=64, num_hidden_layers=3, vocab_size=211,
                   state_size=16, head_dim=16, chunk_size=8,
                   dtype="float32")
        traffic.update(seq=32, markov_eff_vocab=16, gibbs_iters=20)
    else:
        cfg.update(hidden_size=64, num_hidden_layers=3, vocab_size=211,
                   intermediate_size=128, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   num_attention_heads=4, num_key_value_heads=4,
                   n_routed_experts=8, num_experts_per_tok=2,
                   moe_intermediate_size=32, moe_group_size=16)
        traffic.update(prompt=1040, new_tokens=6, sample_requests=8)
    return cfg, traffic


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def load_json(path):
    return json.loads(Path(path).read_text())
