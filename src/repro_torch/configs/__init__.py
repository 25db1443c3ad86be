"""Model configs of the port (the dense and MoE transformer LMs, the
ColBERTer encoder)."""
from repro_torch.configs import (  # noqa: F401  (registers)
    colberter, granite_moe_1b_a400m, llama4_scout_17b_a16e, qwen2_0_5b,
    qwen2_72b, smollm_135m)
from repro_torch.configs.base import (ColberterConfig, MoEConfig,
                                      TransformerConfig, get_config, register)

__all__ = ["ColberterConfig", "MoEConfig", "TransformerConfig", "get_config",
           "register"]
