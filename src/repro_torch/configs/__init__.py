"""Model configs of the port (the dense transformer LMs, the ColBERTer
encoder)."""
from repro_torch.configs import colberter, smollm_135m  # noqa: F401  (registers)
from repro_torch.configs.base import (ColberterConfig, MoEConfig,
                                      TransformerConfig, get_config, register)

__all__ = ["ColberterConfig", "MoEConfig", "TransformerConfig", "get_config",
           "register"]
