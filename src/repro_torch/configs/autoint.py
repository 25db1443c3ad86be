"""autoint — self-attentive feature interaction. [arXiv:1810.11921]

39 sparse fields embed_dim=16, 3 attention layers, 2 heads, d_attn=32.
"""
from repro_torch.configs.base import RecsysConfig, register


@register("autoint")
def autoint() -> RecsysConfig:
    return RecsysConfig(
        name="autoint",
        variant="autoint",
        n_dense=0,
        embed_dim=16,
        table_sizes=tuple([1_000_000] * 39),
        n_attn_layers=3,
        n_attn_heads=2,
        d_attn=32,
    )
