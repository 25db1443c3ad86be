"""qwen2-72b — dense GQA LM with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import TransformerConfig, register


@register("qwen2-72b")
def qwen2_72b() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b",
        family="lm-dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=29_568,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
