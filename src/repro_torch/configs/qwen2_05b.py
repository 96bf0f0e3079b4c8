"""qwen2-0.5b [dense]: 24L, d=896, 14H (kv=2, head_dim=64), d_ff=4864,
vocab=151936, QKV bias, tied embeddings. [arXiv:2407.10671]"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        d_model=896, n_layers=24, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151936,
        pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    )
