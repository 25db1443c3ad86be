"""llama4-scout-17b-a16e — 16-expert top-1 MoE + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The modality frontend (early fusion) is not modelled: the model takes token
ids only.
"""
from repro_torch.configs.base import MoEConfig, TransformerConfig, register


@register("llama4-scout-17b-a16e")
def llama4_scout() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-17b-a16e",
        family="lm-moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=202_048,
        qkv_bias=False,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      n_shared_experts=1),
        rope_theta=500_000.0,
    )
