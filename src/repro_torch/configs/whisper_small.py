"""whisper-small [audio]: enc-dec, 12 enc + 12 dec layers, d=768, 12H
(kv=12), d_ff=3072, vocab=51865. Conv/log-mel frontend is a STUB —
input_specs provides precomputed frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        d_model=768, n_layers=24, n_enc_layers=12, encdec=True,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=51865,
        pattern=(LayerSpec("attn", "dense"),),
        norm_kind="layernorm", act="gelu", glu=False, qkv_bias=True,
        tie_embeddings=True, enc_seq=1500,
    )
