"""qwen3-32b [dense]: 64L, d=5120, 64H (kv=8, head_dim=128 explicit),
d_ff=25600, vocab=151936, qk_norm, no QKV bias. [hf:Qwen/Qwen3]"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        d_model=5120, n_layers=64, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=25600, vocab_size=151936,
        pattern=(LayerSpec("attn", "dense"),),
        qk_norm=True, tie_embeddings=False, rope_theta=1e6,
    )
