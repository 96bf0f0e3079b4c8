"""jamba-v0.1-52b [hybrid]: 32L, d=4096, attn:mamba 1:7 (attn at offset 4
of each 8-layer period), MoE 16e top-2 every other layer, 32H (kv=8),
d_ff=14336, vocab=65536. [arXiv:2403.19887; hf]

Note: Jamba v0.1 uses Mamba-1 internally; this framework uses the Mamba-2
SSD block (d_state=16 as in Jamba) — the TPU-native choice (chunked SSD maps
onto the MXU; see DESIGN.md hardware-adaptation notes).
"""
from repro_torch.configs.base import LayerSpec, MoECfg, ModelConfig, SSMCfg


def config() -> ModelConfig:
    # 8-layer period: attn at offset 4, mamba elsewhere; MoE at odd offsets.
    period = tuple(
        LayerSpec("attn" if i == 4 else "mamba",
                  "moe" if i % 2 == 1 else "dense")
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        pattern=period,
        moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=14336, group_size=512),
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, headdim=64, ngroups=1,
                   chunk_size=256),
        tie_embeddings=False,
    )
