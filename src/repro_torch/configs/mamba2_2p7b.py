"""mamba2-2.7b [ssm]: 64L, d=2560, attention-free, ssm_state=128,
headdim=64, expand=2, vocab=50280. SSD (state-space duality).
[arXiv:2405.21060]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMCfg


def config() -> ModelConfig:
    # vocab: 50280 logical (GPT-NeoX tokenizer) padded to 50304 — the
    # standard NeoX padded table size — so the vocab dim shards over
    # 16-way TP (50280 % 16 != 0 would force a replicated LM head).
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        d_model=2560, n_layers=64, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=50304,
        pattern=(LayerSpec("mamba", "none"),),
        ssm=SSMCfg(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1,
                   chunk_size=256),
        tie_embeddings=True,
    )
