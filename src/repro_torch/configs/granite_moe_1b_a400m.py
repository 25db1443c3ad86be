"""granite-moe-1b-a400m — 32-expert top-8 MoE LM.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import MoEConfig, TransformerConfig, register


@register("granite-moe-1b-a400m")
def granite_moe() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m",
        family="lm-moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=64,
        d_ff=512,                     # per-expert ffn width
        vocab_size=49_155,
        qkv_bias=False,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
