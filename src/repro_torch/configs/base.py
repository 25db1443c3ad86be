"""Model configs (the transformer LM, the ColBERTer encoder) and a small
registry.

The reference's ``TransformerConfig`` and ``ColberterConfig`` with torch
dtypes and without the knobs that only change how XLA lowers the model
(sharding axes, layer scan, remat, the one-hot cache write, unrolled chunk
loops, a sharded encode, a reduced-precision score block): the port runs one
device and computes the reference's default numerics (fp32 attention scores,
every kv chunk visited).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0       # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    family: str                      # "lm-dense" | "lm-moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_chunk: int = 1024           # kv-chunk for blockwise online-softmax attn
    max_seq_len: int = 524_288

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def scaled(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ColberterConfig:
    """Late-interaction dual-head encoder (the paper's own model family):
    a distilBERT-like backbone, a single-vector CLS head (candidate
    generation) and a per-token BOW head (MaxSim re-ranking)."""
    name: str = "colberter"
    family: str = "retrieval"
    n_layers: int = 6                # distilBERT-like
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 30_522
    d_cls: int = 128                 # single-vector head dim
    d_bow: int = 32                  # multi-vector (token) head dim
    max_doc_len: int = 180
    max_query_len: int = 32
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    norm_eps: float = 1e-12
    attn_chunk: int = 512
    qkv_bias: bool = True

    def scaled(self, **kw) -> "ColberterConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, Callable[[], Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str):
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every config)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
