"""colberter — the paper's own late-interaction dual-head encoder.

distilBERT backbone (6L/768d) producing a 128-d CLS vector (candidate
generation) + 32-d per-token BOW vectors (MaxSim re-ranking), as in
Hofstaetter et al. CIKM'22 and used throughout ESPN.
"""
from repro_torch.configs.base import ColberterConfig, register


@register("colberter")
def colberter() -> ColberterConfig:
    return ColberterConfig()
