"""gatedgcn — 16-layer GatedGCN (edge-gated message passing). [arXiv:2003.00982]"""
from repro_torch.configs.base import GNNConfig, register


@register("gatedgcn")
def gatedgcn() -> GNNConfig:
    return GNNConfig(
        name="gatedgcn",
        n_layers=16,
        d_hidden=70,
        aggregator="gated",
        d_in=1433,          # per-shape d_feat overrides at lowering time
        n_classes=47,       # max over shape datasets (ogbn-products has 47)
    )
