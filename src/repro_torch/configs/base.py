"""Model configs (the transformer LM, the ColBERTer encoder, GatedGCN, the
RecSys models), the assigned input shapes of each family, and a small
registry.

Every config is the reference's field for field, in the reference's order
and with its defaults, torch dtypes in place of jnp ones. The knobs act as
the reference's do: ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), ``causal_skip`` visits only the kv chunks at
or below each query chunk's diagonal, ``score_dtype`` rounds the attention
score and probability blocks (ColBERTer: the MaxSim score block),
``seq_shard_acts`` saves the LM's remat residual sequence-sharded over TP,
``onehot_cache_update`` writes the decode cache by a one-hot select. The
sharding knobs ``batch_axes`` and ``tp_axis`` (the LM's activation
constraints), ``seq_shard_acts`` and ``shard_encode`` (ColBERTer's encode
over the whole mesh) redistribute DTensors in the dry run
(``launch/steps.py``) and leave plain tensors alone. ``scan_layers`` and
``attn_unroll`` choose how XLA lowers the reference's loops and have no
effect on the port: its layer and kv-chunk loops are Python loops, the
unrolled form.
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
    remat: bool = True               # recompute each layer in the backward
    max_seq_len: int = 524_288
    # activation-sharding constraint axes (set by the launcher; None = off)
    batch_axes: Any = None           # e.g. ("data",) or ("pod", "data")
    tp_axis: Any = None              # e.g. "model"
    scan_layers: bool = True         # no effect on the port: one layer loop
    attn_unroll: bool = False        # no effect on the port: one chunk loop
    causal_skip: bool = False        # skip fully-masked kv chunks (q-chunked)
    score_dtype: Any = torch.float32  # attention score/probability dtype
    seq_shard_acts: bool = False     # sequence-shard the saved residual carry
    onehot_cache_update: bool = False  # decode cache written by a one-hot select

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
    remat: bool = False              # recompute each layer in the backward
    scan_layers: bool = True         # no effect on the port: one layer loop
    attn_unroll: bool = False        # no effect on the port: one chunk loop
    score_dtype: Any = torch.float32  # MaxSim score-block dtype
    shard_encode: bool = False       # dry run: encode over the whole mesh

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


# ---------------------------------------------------------------------------
# input_specs — meta-tensor stand-ins for every (arch x shape) cell
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(config, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """The model inputs of one (arch, shape) cell as empty ``meta`` tensors
    of the reference's shapes and dtypes (never allocates).

    These are the *data* inputs only; parameter / optimizer-state shapes come
    from the model module's ``param_shapes``.
    """
    i32, f32 = torch.int32, torch.float32
    fam = config.family
    if fam in ("lm-dense", "lm-moe"):
        b, s = shape.dims["global_batch"], shape.dims["seq_len"]
        if shape.kind == "train":
            return {"tokens": _meta((b, s), i32),
                    "targets": _meta((b, s), i32)}
        if shape.kind == "prefill":
            return {"tokens": _meta((b, s), i32)}
        if shape.kind == "decode":
            return {"tokens": _meta((b, 1), i32),
                    "positions": _meta((b,), i32)}
    if fam == "gnn":
        d = shape.dims
        if shape.name == "minibatch_lg":
            # 2-hop sampled block (padded worst case): seeds + fanout0 +
            # fanout0*fanout1
            n_sub = d["batch_nodes"] * (1 + d["fanout0"]
                                        + d["fanout0"] * d["fanout1"])
            e_sub = pad512(d["batch_nodes"] * (d["fanout0"]
                                               + d["fanout0"] * d["fanout1"]))
            return {"node_feats": _meta((n_sub, d["d_feat"]), f32),
                    "edge_src": _meta((e_sub,), i32),
                    "edge_dst": _meta((e_sub,), i32),
                    "labels": _meta((d["batch_nodes"],), i32),
                    "label_nodes": _meta((d["batch_nodes"],), i32)}
        if shape.name == "molecule":
            n = d["n_nodes"] * d["batch"]
            e = pad512(d["n_edges"] * d["batch"])
            return {"node_feats": _meta((n, d["d_feat"]), f32),
                    "edge_src": _meta((e,), i32),
                    "edge_dst": _meta((e,), i32),
                    "graph_ids": _meta((n,), i32),
                    "labels": _meta((d["batch"],), i32)}
        e = pad512(d["n_edges"])
        return {"node_feats": _meta((d["n_nodes"], d["d_feat"]), f32),
                "edge_src": _meta((e,), i32),
                "edge_dst": _meta((e,), i32),
                "labels": _meta((d["n_nodes"],), i32)}
    if fam == "recsys":
        b = shape.dims["batch"]
        if shape.name == "retrieval_cand":
            nc = pad512(shape.dims["n_candidates"])
            if config.variant == "two-tower":
                return {"query_ids": _meta((b, config.n_query_fields), i32),
                        "candidate_ids": _meta((nc, config.n_item_fields),
                                               i32)}
            # CTR models score 1M assembled rows (user fields broadcast into
            # each candidate's feature vector by the host pipeline)
            specs = {"sparse_ids": _meta((nc, config.n_sparse), i32)}
            if config.n_dense:
                specs["dense"] = _meta((nc, config.n_dense), f32)
            return specs
        if config.variant == "two-tower":
            specs = {"query_ids": _meta((b, config.n_query_fields), i32),
                     "item_ids": _meta((b, config.n_item_fields), i32)}
            if shape.kind == "train":
                specs["labels"] = _meta((b,), i32)
            return specs
        specs = {"sparse_ids": _meta((b, config.n_sparse), i32)}
        if config.n_dense:
            specs["dense"] = _meta((b, config.n_dense), f32)
        if shape.kind == "train":
            specs["labels"] = _meta((b,), f32)
        return specs
    if fam == "retrieval":
        b = shape.dims["batch"]
        k = shape.dims["k_docs"]
        return {
            "query_tokens": _meta((b, config.max_query_len), i32),
            "doc_bow": _meta((b, k, config.max_doc_len, config.d_bow),
                             torch.bfloat16),
            "doc_lens": _meta((b, k), i32),
            "cls_scores": _meta((b, k), f32),
        }
    raise ValueError(f"no input specs for family {fam} shape {shape.name}")
