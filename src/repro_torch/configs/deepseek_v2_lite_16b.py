"""deepseek-v2-lite-16b [moe]: 27L, d=2048, 16H, MLA (kv_lora=512, rope 64,
nope 128, v 128), vocab=102400; MoE: 2 shared + 64 routed top-6,
d_ff_expert=1408; first layer dense (d_ff=10944). [arXiv:2405.04434; hf]

Assignment-line note: the line says both "64e" and "160 routed"; the HF
V2-LITE config is 64 routed + 2 shared — implemented here (see DESIGN.md).
"""
from repro_torch.configs.base import LayerSpec, MLACfg, MoECfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        d_model=2048, n_layers=27, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400,
        prologue=(LayerSpec("attn", "dense"),),       # first_k_dense = 1
        pattern=(LayerSpec("attn", "moe"),),          # 26 MoE layers
        attn_kind="mla",
        mla=MLACfg(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128),
        moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408,
                   n_shared_experts=2, group_size=512),
        tie_embeddings=False, rope_theta=1e4,
    )
