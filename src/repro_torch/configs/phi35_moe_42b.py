"""phi3.5-moe-42b-a6.6b [moe]: 32L, d=4096, 32H (kv=8), 16 experts top-2,
d_ff_expert=6400, vocab=32064. [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import LayerSpec, MoECfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064,
        pattern=(LayerSpec("attn", "moe"),),
        moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=6400, group_size=512),
        tie_embeddings=False, rope_theta=1e4,
    )
