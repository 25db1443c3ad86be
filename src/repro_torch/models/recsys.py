"""RecSys architectures: FM, DLRM (MLPerf), AutoInt, two-tower retrieval.

All share the embedding tables of ``models/embedding.py``. The hot path is
the embedding lookup, the direct analogue of ESPN's BOW-table access, so
these archs are where the paper's storage offload plugs in
(``storage/espn_embedding.py``).

Parameters are the reference's nested dict (``tables/table_{i}``,
``bot/w0``, ``attn_0/wq``, ...) of fp32 masters; compute casts them to the
config's dtype at the reference's rounding points. Three products are taken
in fp32 whatever the compute dtype, as in the reference: AutoInt's scores
(bf16 q and k, fp32 product), DLRM's pairwise interaction and the towers'
dot products. On the card the caller keeps TF32 off (``resolve_device``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.maxsim import topk_stable
from repro_torch.device import resolve_device
from repro_torch.models import embedding as emb
from repro_torch.models.layers import (dense_init, in_batch_scores,
                                       is_dtensor, mlp_apply, mlp_shapes)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def param_shapes(cfg: RecsysConfig) -> dict:
    """The reference's nested parameter dict as empty ``meta`` tensors
    (stored table rows included)."""
    pdt = cfg.param_dtype
    p: dict = {"tables": emb.table_shapes(cfg.table_sizes, cfg.embed_dim,
                                          pdt)}
    if cfg.variant == "fm":
        p["linear"] = emb.table_shapes(cfg.table_sizes, 1, pdt)
        p["bias"] = torch.empty((), dtype=pdt, device="meta")
    elif cfg.variant == "dlrm":
        p["bot"] = mlp_shapes((cfg.n_dense,) + cfg.bot_mlp, pdt)
        n_int = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        p["top"] = mlp_shapes((n_int + cfg.bot_mlp[-1],) + cfg.top_mlp, pdt)
    elif cfg.variant == "autoint":
        d, dh, nh = cfg.embed_dim, cfg.d_attn, cfg.n_attn_heads
        for l in range(cfg.n_attn_layers):
            d_in = d if l == 0 else dh * nh
            p[f"attn_{l}"] = {
                n: torch.empty((d_in, nh * dh), dtype=pdt, device="meta")
                for n in ("wq", "wk", "wv", "wres")}
        p["out"] = mlp_shapes((cfg.n_sparse * dh * nh, 1), pdt)
    elif cfg.variant == "two-tower":
        p["q_tower"] = mlp_shapes(
            (cfg.n_query_fields * cfg.embed_dim,) + cfg.tower_mlp, pdt)
        p["i_tower"] = mlp_shapes(
            (cfg.n_item_fields * cfg.embed_dim,) + cfg.tower_mlp, pdt)
    else:
        raise ValueError(cfg.variant)
    return p


def param_logical_axes(cfg: RecsysConfig) -> dict:
    """The reference's tree of logical axes: the tables' rows over the mesh
    (``embedding.table_logical_axes``), every other parameter replicated."""
    def none(tree):
        return {k: none(v) if isinstance(v, dict) else (None,) * v.dim()
                for k, v in tree.items()}
    axes = none(param_shapes(cfg))
    axes["tables"] = emb.table_logical_axes(cfg.table_sizes)
    if cfg.variant == "fm":
        axes["linear"] = emb.table_logical_axes(cfg.table_sizes)
    return axes


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """The reference's init kinds, drawn on ``generator``'s device and
    placed on ``device``: LeCun-normal fan-in (rows) for every matrix
    (FM's linear tables too), zeros for vectors and the bias, and the
    embedding tables N(0, 1) x rows^-0.25 x 0.1 (``init_tables``)."""
    dev = resolve_device(device)

    def draw(shapes: dict) -> dict:
        out = {}
        for k, v in shapes.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif v.dim() >= 2:
                out[k] = dense_init(generator, tuple(v.shape), in_axis=-2,
                                    dtype=v.dtype).to(dev)
            else:
                out[k] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
        return out

    shapes = param_shapes(cfg)
    del shapes["tables"]
    params = draw(shapes)
    params["tables"] = {k: t.to(dev) for k, t in emb.init_tables(
        generator, cfg.table_sizes, cfg.embed_dim, cfg.param_dtype).items()}
    return params


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _fm_forward(cfg, params, batch):
    dt = cfg.dtype
    v = emb.lookup(params["tables"], batch["sparse_ids"], dt)     # (B, F, D)
    w = emb.lookup(params["linear"], batch["sparse_ids"], dt)     # (B, F, 1)
    vf = v.float()
    # pairwise sum via the O(nk) identity: 1/2 ((sum v)^2 - sum v^2)
    s = vf.sum(dim=1)
    inter = 0.5 * (s * s - (vf * vf).sum(dim=1)).sum(dim=-1)
    return params["bias"].float() + w.float().sum(dim=(1, 2)) + inter


def _dlrm_forward(cfg, params, batch):
    dt = cfg.dtype
    dense = mlp_apply(params["bot"], batch["dense"].to(dt), act_last=True)
    sparse = emb.lookup(params["tables"], batch["sparse_ids"], dt)  # (B,26,D)
    ff = torch.cat([dense[:, None, :], sparse], dim=1).float()     # (B,27,D)
    inter = ff @ ff.transpose(1, 2)                                 # (B,27,27)
    n = ff.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=ff.device)
    top_in = torch.cat([dense.float(), inter[:, iu, ju]], dim=-1)   # (B, 479)
    return mlp_apply(params["top"], top_in.to(dt))[:, 0].float()


def _autoint_forward(cfg, params, batch):
    dt = cfg.dtype
    x = emb.lookup(params["tables"], batch["sparse_ids"], dt)      # (B,F,D)
    nh, dh = cfg.n_attn_heads, cfg.d_attn
    b, f = x.shape[:2]
    for l in range(cfg.n_attn_layers):
        p = params[f"attn_{l}"]
        q, k, v = (x @ p[n].to(dt) for n in ("wq", "wk", "wv"))
        q, k, v = (t.reshape(b, f, nh, dh) for t in (q, k, v))
        # bf16 q and k, their product in fp32 (the reference's
        # preferred_element_type): a bf16 matmul would round it to bf16
        s = torch.einsum("bfhd,bghd->bhfg", q.float(), k.float()) * dh ** -0.5
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a.to(dt), v).reshape(b, f, nh * dh)
        x = F.relu(o + x @ p["wres"].to(dt))
    return mlp_apply(params["out"], x.reshape(b, -1))[:, 0].float()


def _tower(params_mlp, tables, ids, dt):
    e = emb.lookup(tables, ids, dt)                                # (B,F,D)
    hf = mlp_apply(params_mlp, e.reshape(e.shape[0], -1)).float()
    return hf / torch.clamp(torch.linalg.vector_norm(hf, dim=-1,
                                                     keepdim=True), min=1e-6)


def query_embed(cfg: RecsysConfig, params, query_ids):
    """The query tower alone: query_ids (B, n_query_fields) -> (B, d) in
    fp32, unit norm (``two_tower_embed``'s first output)."""
    return _tower(params["q_tower"], params["tables"], query_ids, cfg.dtype)


def two_tower_embed(cfg: RecsysConfig, params, batch):
    """(query embeddings (B, d), item embeddings) in fp32, unit norm; the
    items from ``candidate_ids`` where the batch has them, else
    ``item_ids``. The item fields' tables follow the query fields'."""
    nq, ni = cfg.n_query_fields, cfg.n_item_fields
    q = query_embed(cfg, params, batch["query_ids"])
    key = "candidate_ids" if "candidate_ids" in batch else "item_ids"
    item_tables = {f"table_{i}": params["tables"][f"table_{i + nq}"]
                   for i in range(ni)}
    i = _tower(params["i_tower"], item_tables, batch[key], cfg.dtype)
    return q, i


def forward(cfg: RecsysConfig, params, batch):
    """fp32 logits (B,); two-tower: the (B,) scores of query i against item
    i, or (B, n_candidates) against every candidate."""
    if cfg.variant == "fm":
        return _fm_forward(cfg, params, batch)
    if cfg.variant == "dlrm":
        return _dlrm_forward(cfg, params, batch)
    if cfg.variant == "autoint":
        return _autoint_forward(cfg, params, batch)
    if cfg.variant == "two-tower":
        q, i = two_tower_embed(cfg, params, batch)
        if "candidate_ids" in batch:            # retrieval: score all cands
            return q @ i.T
        return (q * i).sum(dim=-1)
    raise ValueError(cfg.variant)


def retrieval_topk(cfg: RecsysConfig, params, batch, k=100):
    """The top ``k`` (values, indices) of the candidate scores, descending,
    ties to the lower index (as ``jax.lax.top_k``)."""
    return topk_stable(forward(cfg, params, batch), k)


def loss_fn(cfg: RecsysConfig, params, batch):
    """Two-tower: the in-batch sampled softmax over (B, B) logits x 20
    (item i is query i's positive). The others: binary cross-entropy on
    ``labels`` in the stable form max(x, 0) - x y + log1p(exp(-|x|)).
    Returns (loss, {"ce" | "bce": loss})."""
    if cfg.variant == "two-tower":
        q, i = two_tower_embed(cfg, params, batch)
        if is_dtensor(q):       # the dry run: GSPMD's layout of the logits
            logits = in_batch_scores(q, i) * 20.0
            gold = (q * i).sum(dim=-1) * 20.0
        else:
            logits = (q @ i.T) * 20.0
            gold = logits.diagonal()
        loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
        return loss, {"ce": loss}
    logit = forward(cfg, params, batch)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
    return loss, {"bce": loss}


def smoke_config(cfg: RecsysConfig) -> RecsysConfig:
    return cfg.scaled(table_sizes=tuple([997] * cfg.n_sparse))
