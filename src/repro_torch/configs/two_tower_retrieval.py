"""two-tower-retrieval — sampled-softmax retrieval (YouTube RecSys'19).

embed_dim=256 per field, 4 query-side and 4 item-side categorical fields,
tower MLP 1024-512-256 (input = concat of 4x256), dot-product interaction,
in-batch sampled softmax with logQ correction at train time.
"""
from repro_torch.configs.base import RecsysConfig, register


@register("two-tower-retrieval")
def two_tower() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-retrieval",
        variant="two-tower",
        embed_dim=256,
        # query fields: user id, region, device, history-cluster
        # item fields: item id, category, brand, seller
        table_sizes=(100_000_000, 1_000_000, 100_000, 10_000,
                     100_000_000, 100_000, 1_000_000, 100_000),
        tower_mlp=(1024, 512, 256),
        n_query_fields=4,
        n_item_fields=4,
    )
