"""granite-4.0-h-small [hybrid]: 40L, d=4096, a 10-layer period of nine
Mamba-2 layers and one attention layer (at offset 5), a 72-expert top-10
MoE (expert width 768) beside one shared SwiGLU MLP of width 1536 in every
layer; Mamba-2 128 heads x 64, state 128, one group, conv 4 with a bias,
expand 2, chunk 256; GQA 32 heads over 8 KV heads of width 128 with no
positional embedding (NoPE); the muP multipliers: embeddings x 12, each
sublayer's output x 0.22, scores q.k x 1/128 (not 1/sqrt(128)), logits
/ 16; RMSNorm eps 1e-5, tied embeddings, vocab=100352. 32.2 B parameters,
9 B active. [ibm-granite/granite-4.0-h-small config.json,
``model_type`` granitemoehybrid]

The MoE router's softmax over its top-10 logits equals the softmax over
all experts renormalised over the chosen ten, which ``moe_route``
computes. Served in bfloat16 parameters with a float32 router.
"""
from repro_torch.configs.base import (LayerSpec, MoECfg, ModelConfig,
                                      MuPCfg, SSMCfg)


def config() -> ModelConfig:
    period = tuple(LayerSpec("attn" if i == 5 else "mamba", "moe")
                   for i in range(10))
    return ModelConfig(
        name="granite-4.0-h-small", family="hybrid",
        d_model=4096, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
        vocab_size=100352,
        pattern=period,
        rope=False,
        norm_eps=1e-5,
        moe=MoECfg(n_experts=72, top_k=10, d_ff_expert=768,
                   n_shared_experts=1, d_ff_shared=1536, group_size=512),
        ssm=SSMCfg(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1,
                   chunk_size=256),
        mup=MuPCfg(embedding_multiplier=12.0, residual_multiplier=0.22,
                   attention_multiplier=0.0078125, logits_scaling=16.0),
        tie_embeddings=True,
        param_dtype="bfloat16", attn_impl="pallas", ssd_impl="pallas",
    )
