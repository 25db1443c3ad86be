"""Model configs of the port (the dense and MoE transformer LMs, the
ColBERTer encoder, GatedGCN and the RecSys models)."""
from repro_torch.configs import (  # noqa: F401  (registers)
    autoint, colberter, dlrm_mlperf, fm, gatedgcn, granite_moe_1b_a400m,
    llama4_scout_17b_a16e, qwen2_0_5b, qwen2_72b, smollm_135m,
    two_tower_retrieval)
from repro_torch.configs.base import (ColberterConfig, GNNConfig, MoEConfig,
                                      RecsysConfig, TransformerConfig,
                                      get_config, list_archs, register)

__all__ = ["ColberterConfig", "GNNConfig", "MoEConfig", "RecsysConfig",
           "TransformerConfig", "get_config", "list_archs", "register"]
