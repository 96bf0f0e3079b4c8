"""chameleon-34b [vlm]: early-fusion, 48L, d=8192, 64H (kv=8), d_ff=22016,
vocab=65536 (includes VQ image-token codes — the VQ tokenizer is the stub;
inputs are ordinary token ids). qk-norm per the paper. [arXiv:2405.09818]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        d_model=8192, n_layers=48, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536,
        pattern=(LayerSpec("attn", "dense"),),
        qk_norm=True, tie_embeddings=False, rope_theta=1e4,
    )
