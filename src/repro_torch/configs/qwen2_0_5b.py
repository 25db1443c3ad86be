"""qwen2-0.5b — dense GQA LM with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import TransformerConfig, register


@register("qwen2-0.5b")
def qwen2_0_5b() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-0.5b",
        family="lm-dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_head=64,
        d_ff=4864,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
