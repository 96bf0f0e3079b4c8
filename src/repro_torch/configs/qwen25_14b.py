"""qwen2.5-14b [dense]: 48L, d=5120, 40H (kv=8, head_dim=128), d_ff=13824,
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5]"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        d_model=5120, n_layers=48, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=13824, vocab_size=152064,
        pattern=(LayerSpec("attn", "dense"),),
        qkv_bias=True, tie_embeddings=False, rope_theta=1e6,
    )
