"""Model configs (the transformer LM, the ColBERTer encoder, GatedGCN, the
RecSys models), the assigned input shapes of each family, and a small
registry.

The reference's ``TransformerConfig`` and ``ColberterConfig`` with torch
dtypes and without the knobs that only change how XLA lowers the model
(sharding axes, layer scan, remat, the one-hot cache write, unrolled chunk
loops, a sharded encode, a reduced-precision score block): the port runs one
device and computes the reference's default numerics (fp32 attention scores,
every kv chunk visited). ``GNNConfig`` and ``RecsysConfig`` are the
reference's field for field: GatedGCN's ``remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``); its ``scan_layers`` is kept for
the reference's sake only (the port's layer loop is the same either way).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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


@dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str = "gnn"
    n_layers: int = 16
    d_hidden: int = 70
    aggregator: str = "gated"
    d_in: int = 1433                 # overridden per shape
    d_edge_in: int = 0
    n_classes: int = 40
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False              # recompute each layer in the backward
    scan_layers: bool = True         # no effect on the port: one layer loop

    def scaled(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    family: str = "recsys"
    variant: str = "dlrm"            # dlrm | fm | autoint | two-tower
    n_dense: int = 0
    embed_dim: int = 128
    table_sizes: tuple[int, ...] = ()
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # two-tower
    tower_mlp: tuple[int, ...] = ()
    n_query_fields: int = 0
    n_item_fields: int = 0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def scaled(self, **kw) -> "RecsysConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape sets (the assigned input shapes, per family)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                        # "train" | "prefill" | "decode" | "serve"
    dims: dict[str, int] = field(default_factory=dict)


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq_len": 32_768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq_len": 32_768, "global_batch": 128}),
    # decode with a 500k KV cache is O(S) per token
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq_len": 524_288, "global_batch": 1}),
}


def pad512(n: int) -> int:
    """Leading dims padded to a multiple of 512 (the reference's mesh size):
    GNN edge lists with ``dst = n_nodes`` sink edges, which no sum reaches;
    retrieval candidates with extra rows."""
    return -(-n // 512) * 512


GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               {"n_nodes": 2708, "n_edges": 10_556,
                                "d_feat": 1433}),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train",
                              {"n_nodes": 232_965, "n_edges": 114_615_892,
                               "batch_nodes": 1024, "fanout0": 15,
                               "fanout1": 10, "d_feat": 602}),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              {"n_nodes": 2_449_029, "n_edges": 61_859_140,
                               "d_feat": 100}),
    "molecule": ShapeSpec("molecule", "train",
                          {"n_nodes": 30, "n_edges": 64, "batch": 128,
                           "d_feat": 16}),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "serve",
                                {"batch": 1, "n_candidates": 1_000_000}),
}

RETRIEVAL_SHAPES = {
    "serve_q32": ShapeSpec("serve_q32", "serve",
                           {"batch": 32, "k_docs": 1024}),
    "serve_q512": ShapeSpec("serve_q512", "serve",
                            {"batch": 512, "k_docs": 128}),
}

FAMILY_SHAPES = {
    "lm-dense": LM_SHAPES,
    "lm-moe": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
    "retrieval": RETRIEVAL_SHAPES,
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

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


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401  (registers every config)
    return sorted(_REGISTRY)


def shapes_for(config) -> dict[str, ShapeSpec]:
    return FAMILY_SHAPES[config.family]
