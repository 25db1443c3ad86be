"""fm — factorization machine, 2-way interactions via the O(nk) sum-square
trick. [Rendle ICDM'10]

39 sparse fields (Criteo-style, hashed to 1e6 rows/field — the hashing trick,
QR-embed arXiv:1909.02107) with embed_dim 10.
"""
from repro_torch.configs.base import RecsysConfig, register


@register("fm")
def fm() -> RecsysConfig:
    return RecsysConfig(
        name="fm",
        variant="fm",
        n_dense=0,
        embed_dim=10,
        table_sizes=tuple([1_000_000] * 39),
    )
