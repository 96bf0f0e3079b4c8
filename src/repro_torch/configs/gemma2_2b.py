"""gemma2-2b [dense]: 26L, d=2304, 8H (kv=4, head_dim=256), d_ff=9216
(GeGLU), vocab=256000; local(4096)/global alternating; attn softcap 50,
final softcap 30; post-sublayer norms; tied + scaled embeddings.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        d_model=2304, n_layers=26, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256000,
        pattern=(LayerSpec("attn", "dense", window=4096),
                 LayerSpec("attn", "dense", window=0)),
        attn_softcap=50.0, final_softcap=30.0,
        act="gelu", glu=True, post_norm=True,
        tie_embeddings=True, embed_scale=True, rope_theta=1e4,
    )
