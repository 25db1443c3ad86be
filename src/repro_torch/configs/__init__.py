"""Model configs of the port (the dense transformer LMs)."""
from repro_torch.configs import smollm_135m  # noqa: F401  (registers)
from repro_torch.configs.base import (MoEConfig, TransformerConfig, get_config,
                                      register)

__all__ = ["MoEConfig", "TransformerConfig", "get_config", "register"]
