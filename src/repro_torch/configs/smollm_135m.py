"""smollm-135m — llama-arch small dense GQA LM. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import TransformerConfig, register


@register("smollm-135m")
def smollm_135m() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-135m",
        family="lm-dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_head=64,
        d_ff=1536,
        vocab_size=49_152,
        qkv_bias=False,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
