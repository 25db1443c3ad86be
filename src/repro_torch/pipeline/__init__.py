"""``repro_torch.pipeline`` — the user-facing API for the ported stack.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:   # device="cuda"
        print(pipe.evaluate())
"""
from repro_torch.pipeline.backends import (RetrievalBackend,
                                           available_backends, get_backend,
                                           register_backend)
from repro_torch.pipeline.config import (ClusterConfig, CorpusConfig,
                                         IndexConfig, MutationConfig,
                                         PipelineConfig, RetrievalConfig,
                                         ServeConfig, StorageConfig)
from repro_torch.pipeline.pipeline import Pipeline

__all__ = [
    "Pipeline", "PipelineConfig", "CorpusConfig", "IndexConfig",
    "StorageConfig", "RetrievalConfig", "ClusterConfig", "MutationConfig",
    "ServeConfig", "RetrievalBackend",
    "register_backend", "get_backend", "available_backends",
]
