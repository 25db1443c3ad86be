"""The dry run's cells: one (step_fn, args, shardings) per (architecture x
input shape) pair, the unit of the multi-pod dry run.

The cells, shapes, shardings and model-FLOP formulas are the reference's
(``repro.launch.steps``). ``args`` are trees of ``meta`` tensors (the
counterpart of its ``ShapeDtypeStruct``s) and the shardings are
``partitioning.Sharding``s (mesh + DTensor placements) resolved from the
models' logical axes through ``mesh.mesh_axes``. The dry run
(``launch/dryrun.py``) lays each argument out as a DTensor of that sharding
and runs ``step_fn`` on it; the same ``step_fn`` runs on plain tensors too.
The steps call the port's own models and optimizers; on CPU-typed tensors
(the dry run's fake ones included) they take the plain PyTorch path, as the
reference's dry run takes plain ``jnp`` and not Pallas.

Where a reference step reads a value the port keeps as a Python int (the
decode step's cache ``length``), the step fixes it: a decode cell writes the
cache's last slot and attends over the whole cache, as the reference's
masked decode attention reads the whole cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.maxsim import maxsim_scores, topk_stable
from repro_torch.configs.base import (ColberterConfig, GNNConfig,
                                      RecsysConfig, ShapeSpec,
                                      TransformerConfig, get_config,
                                      input_specs, shapes_for)
from repro_torch.launch.mesh import mesh_axes
from repro_torch.launch.partitioning import (like_tree, named_sharding,
                                             replicated, resolve_tree)
from repro_torch.models import colberter as colberter_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (constrain, is_dtensor,
                                       partials_reduced)
from repro_torch.train.optimizer import AdamW, named_params


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    note: str = ""
    model_flops: float = 0.0        # 6*N*D (dense) / 6*N_active*D (MoE) etc.


class ParamTree:
    """A nested dict of parameters read the way the port's model objects
    are read: ``p.embed``, ``p.embed_norm.scale``, ``p.layer(i)`` (layer
    ``i`` of every stacked ``layers`` tensor, nested names joined by "/").

    ``gather``: mesh axes (the FSDP axis) a DTensor parameter is gathered
    over where it is read, as ZeRO-3 gathers a layer's weights before its
    products (and reduce-scatters their gradients back); plain tensors pass
    through."""

    def __init__(self, tree: dict, gather: tuple = ()):
        self._tree = tree
        self._gather = gather

    def _read(self, t):
        if not self._gather or not is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        names = t.device_mesh.mesh_dim_names
        placements = tuple(Replicate() if names[i] in self._gather else p
                           for i, p in enumerate(t.placements))
        if placements == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, placements)

    def __getattr__(self, name):
        try:
            v = self._tree[name]
        except KeyError:
            raise AttributeError(name) from None
        return (ParamTree(v, self._gather) if isinstance(v, dict)
                else self._read(v))

    def layer(self, i: int) -> dict:
        return {k: self._read(v[i])
                for k, v in named_params(self._tree["layers"]).items()}


def _ns(mesh, *axes):
    return named_sharding(mesh, axes)


def _value_and_grads(loss_fn, params: dict, *inputs):
    """(loss, metrics, {name: grad}) of ``loss_fn(params, *inputs)``; the
    parameters are made leaves that require grad. On a mesh of several
    devices a DTensor gradient that holds partial sums is all-reduced once,
    here (as GSPMD reduces each gradient once), not again at every read of
    it in the optimizer."""
    leaves = named_params(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, *inputs)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    grads = [partials_reduced(g) if is_dtensor(g) and g.device_mesh.size() > 1
             else g for g in grads]
    return loss.detach(), metrics, dict(zip(leaves, grads))


def _train_step(loss_fn, opt):
    def step(params, opt_state, batch):
        loss, _, grads = _value_and_grads(loss_fn, params, batch)
        new_p, new_o, gnorm = opt.update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss, "gnorm": gnorm}
    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_param_shardings(cfg: TransformerConfig, mesh, rules):
    return resolve_tree(tfm.param_logical_axes(cfg), mesh, rules)


def _lm_model_flops(cfg: TransformerConfig, n_tokens: int, *,
                    train: bool) -> float:
    """6*N*D with N = active params (MoE counts top_k+shared experts)."""
    D, H, KV, Dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                             cfg.n_layers)
    attn = D * (H + 2 * KV) * Dh + H * Dh * D
    if cfg.moe is None:
        ffn = 3 * D * F
    else:
        m = cfg.moe
        ffn = 3 * D * m.d_ff_expert * (m.top_k + m.n_shared_experts)
    n_active = L * (attn + ffn) + V * D * (1 if cfg.tie_embeddings else 2)
    mult = 6.0 if train else 2.0
    return mult * n_active * n_tokens


def lm_cell(cfg: TransformerConfig, shape: ShapeSpec, mesh,
            grad_accum: int = 1) -> Cell:
    rules = mesh_axes(mesh)
    batch_ax = rules["batch"]
    psh = _lm_param_shardings(cfg, mesh, rules)
    pshapes = tfm.param_shapes(cfg)
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    specs = input_specs(cfg, shape)
    # activation-sharding constraints; B=1 cannot shard batch
    cfg = cfg.scaled(batch_axes=batch_ax if b > 1 else None, tp_axis="model")
    # ZeRO-3: a product over many rows gathers its weights over the FSDP
    # axis (an MoE layer's expert buffer has G x E x C rows, in decode
    # too); a dense decode step's few tokens keep them sharded (partial
    # sums)
    fsdp = ((rules["fsdp"],) if shape.kind != "decode" or cfg.moe is not None
            else ())

    if shape.kind == "train":
        opt = AdamW()
        oshapes = opt.init_shapes(pshapes)
        flat_psh = named_params(psh)
        osh = {"m": flat_psh, "v": flat_psh, "step": replicated(mesh)}

        def lf(p, mb):
            return tfm.loss_fn(cfg, ParamTree(p, fsdp), mb)

        if grad_accum == 1:
            step = _train_step(lf, opt)
        else:                        # microbatched (perf flag: grad_accum=N)
            def step(params, opt_state, batch):
                grads, loss = None, 0.0
                for i in range(grad_accum):
                    mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                       *v.shape[1:])[i]
                          for k, v in batch.items()}
                    l, _, g = _value_and_grads(lf, params, mb)
                    g = {k: x.float() for k, x in g.items()}
                    grads = g if grads is None else {
                        k: grads[k] + g[k] for k in g}
                    loss = loss + l
                grads = {k: g / grad_accum for k, g in grads.items()}
                new_p, new_o, gnorm = opt.update(grads, opt_state, params)
                return new_p, new_o, {"loss": loss / grad_accum,
                                      "gnorm": gnorm}

        in_sh = (psh, osh, {"tokens": _ns(mesh, batch_ax, None),
                            "targets": _ns(mesh, batch_ax, None)})
        out_sh = (psh, osh, replicated(mesh))
        return Cell(cfg.name, shape.name, "train", step,
                    (pshapes, oshapes, specs), in_sh, out_sh,
                    model_flops=_lm_model_flops(cfg, b * s, train=True))

    if shape.kind == "prefill":
        cshapes = tfm.cache_shapes(cfg, b, s)
        csh = {"k": _ns(mesh, None, batch_ax, "model", None, None),
               "v": _ns(mesh, None, batch_ax, "model", None, None),
               "slot_pos": _ns(mesh, batch_ax, "model"),
               "length": replicated(mesh)}

        def step(params, tokens, cache):
            return tfm.prefill(cfg, ParamTree(params, fsdp), tokens, cache)

        in_sh = (psh, _ns(mesh, batch_ax, None), csh)
        out_sh = (_ns(mesh, batch_ax, "model"), csh)
        return Cell(cfg.name, shape.name, "prefill", step,
                    (pshapes, specs["tokens"], cshapes), in_sh, out_sh,
                    model_flops=_lm_model_flops(cfg, b * s, train=False))

    # decode: KV cache sequence-sharded; batch=1 shards S over the whole mesh
    cshapes = tfm.cache_shapes(cfg, b, s)
    if b == 1:
        seq_ax = rules["kv_all"]
        csh = {"k": _ns(mesh, None, None, seq_ax, None, None),
               "v": _ns(mesh, None, None, seq_ax, None, None),
               "slot_pos": _ns(mesh, None, seq_ax),
               "length": replicated(mesh)}
        tok_sh = replicated(mesh)
        pos_sh = replicated(mesh)
        logit_sh = _ns(mesh, None, "model")
    else:
        csh = {"k": _ns(mesh, None, batch_ax, "model", None, None),
               "v": _ns(mesh, None, batch_ax, "model", None, None),
               "slot_pos": _ns(mesh, batch_ax, "model"),
               "length": replicated(mesh)}
        tok_sh = _ns(mesh, batch_ax, None)
        pos_sh = _ns(mesh, batch_ax)
        logit_sh = _ns(mesh, batch_ax, "model")

    def step(params, tokens, positions, cache):
        # the port's cache length is a Python int: the last slot
        cache = dict(cache, length=cache["k"].shape[2] - 1)
        return tfm.decode_step(cfg, ParamTree(params, fsdp), tokens,
                               positions, cache)

    in_sh = (psh, tok_sh, pos_sh, csh)
    out_sh = (logit_sh, csh)
    return Cell(cfg.name, shape.name, "decode", step,
                (pshapes, specs["tokens"], specs["positions"], cshapes),
                in_sh, out_sh,
                model_flops=_lm_model_flops(cfg, b, train=False))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def gnn_cell(cfg: GNNConfig, shape: ShapeSpec, mesh) -> Cell:
    rules = mesh_axes(mesh)
    edge_ax = rules["edges"]
    d_in = shape.dims["d_feat"]
    pshapes = gnn_lib.param_shapes(cfg, d_in)
    psh = like_tree(pshapes, replicated(mesh))
    opt = AdamW()
    oshapes = opt.init_shapes(pshapes)
    flat_psh = named_params(psh)
    osh = {"m": flat_psh, "v": flat_psh, "step": replicated(mesh)}
    specs = input_specs(cfg, shape)

    bsh = {}
    for k in specs:
        if k in ("edge_src", "edge_dst"):
            bsh[k] = _ns(mesh, edge_ax)
        else:
            bsh[k] = replicated(mesh)

    step = _train_step(lambda p, batch: gnn_lib.loss_fn(cfg, p, batch), opt)

    n_edges = specs["edge_src"].shape[0]
    n_nodes = specs["node_feats"].shape[0]
    D = cfg.d_hidden
    # GatedGCN model flops (optimal schedule): per layer the edge-state
    # transform e@C is per-edge (2*E*D^2), the four node transforms
    # (A,B,Dm,E) are node-level (4*2*N*D^2), gates/aggregation ~6*E*D;
    # x3 for fwd+bwd.
    flops = 3.0 * cfg.n_layers * (2 * n_edges * D * D
                                  + 8 * n_nodes * D * D + 6 * n_edges * D)
    return Cell(cfg.name, shape.name, "train", step,
                (pshapes, oshapes, specs),
                (psh, osh, bsh), (psh, osh, replicated(mesh)),
                model_flops=flops)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def recsys_cell(cfg: RecsysConfig, shape: ShapeSpec, mesh) -> Cell:
    rules = mesh_axes(mesh)
    batch_ax = rules["batch"]
    pshapes = recsys_lib.param_shapes(cfg)
    psh = resolve_tree(recsys_lib.param_logical_axes(cfg), mesh, rules)
    specs = input_specs(cfg, shape)

    bsh = {}
    cand_mode = shape.name == "retrieval_cand"
    for k, sds in specs.items():
        if k == "candidate_ids" or (cand_mode and k in ("sparse_ids",
                                                        "dense")):
            bsh[k] = _ns(mesh, rules["cands"], None)
        elif sds.dim() and sds.shape[0] > 1:
            bsh[k] = _ns(mesh, batch_ax, *([None] * (sds.dim() - 1)))
        else:
            bsh[k] = replicated(mesh)

    b = shape.dims["batch"]
    if shape.name == "retrieval_cand":
        b = shape.dims["n_candidates"]
    emb_flops = 2.0 * b * cfg.n_sparse * cfg.embed_dim
    # dense-param flops (embedding tables are lookups, not matmuls)
    dense_params = 0
    for path, t in named_params(pshapes).items():
        if "tables" not in path and "linear" not in path and t.dim() == 2:
            dense_params += t.shape[0] * t.shape[1]
    # feature-interaction flops per variant
    F, D = cfg.n_sparse, cfg.embed_dim
    if cfg.variant == "fm":
        inter = 4.0 * b * F * D
    elif cfg.variant == "dlrm":
        inter = 2.0 * b * (F + 1) * (F + 1) * D
    elif cfg.variant == "autoint":
        dh = cfg.d_attn * cfg.n_attn_heads
        inter = cfg.n_attn_layers * 4.0 * b * F * F * dh
    else:                                       # two-tower dot
        inter = 2.0 * b * cfg.tower_mlp[-1]
    fwd = emb_flops + 2.0 * b * dense_params + inter
    if cfg.variant == "two-tower":
        if shape.kind == "train":
            fwd += 2.0 * b * b * cfg.tower_mlp[-1]   # in-batch softmax
        if shape.name == "retrieval_cand":
            # query tower runs once, item tower per candidate
            fwd = emb_flops + b * dense_params + inter

    if shape.kind == "train":
        opt = AdamW()
        oshapes = opt.init_shapes(pshapes)
        flat_psh = named_params(psh)
        osh = {"m": flat_psh, "v": flat_psh, "step": replicated(mesh)}
        step = _train_step(
            lambda p, batch: recsys_lib.loss_fn(cfg, p, batch), opt)
        return Cell(cfg.name, shape.name, "train", step,
                    (pshapes, oshapes, specs),
                    (psh, osh, bsh), (psh, osh, replicated(mesh)),
                    model_flops=3.0 * fwd)

    if shape.name == "retrieval_cand":
        if cfg.variant == "two-tower":
            def step(params, batch):
                return recsys_lib.retrieval_topk(cfg, params, batch, k=100)
        else:
            def step(params, batch):
                scores = recsys_lib.forward(cfg, params, batch)   # (NC,)
                return topk_stable(scores, 100)
        out_sh = (replicated(mesh), replicated(mesh))
        return Cell(cfg.name, shape.name, "serve", step, (pshapes, specs),
                    (psh, bsh), out_sh, model_flops=fwd)

    def step(params, batch):
        return recsys_lib.forward(cfg, params, batch)

    return Cell(cfg.name, shape.name, "serve", step, (pshapes, specs),
                (psh, bsh), _ns(mesh, batch_ax), model_flops=fwd)


# ---------------------------------------------------------------------------
# Retrieval (colberter / the paper's own serving step)
# ---------------------------------------------------------------------------

def retrieval_cell(cfg: ColberterConfig, shape: ShapeSpec, mesh) -> Cell:
    rules = mesh_axes(mesh)
    batch_ax = rules["batch"]
    pshapes = colberter_lib.param_shapes(cfg)
    psh = like_tree(pshapes, replicated(mesh))
    specs = input_specs(cfg, shape)
    bsh = {
        "query_tokens": _ns(mesh, batch_ax, None),
        "doc_bow": _ns(mesh, batch_ax, "model", None, None),
        "doc_lens": _ns(mesh, batch_ax, "model"),
        "cls_scores": _ns(mesh, batch_ax, "model"),
    }

    full_ax = rules["cands"]

    def step(params, batch):
        qt = batch["query_tokens"]
        if cfg.shard_encode:          # encode over the FULL mesh
            qt = constrain(qt, (full_ax, None))
        _, q_bow, q_mask = colberter_lib.encode(cfg, ParamTree(params), qt)
        if cfg.shard_encode:          # reshard for the K-sharded MaxSim
            q_bow = constrain(q_bow, (batch_ax, None, None))
            q_mask = constrain(q_mask, (batch_ax, None))
        t = batch["doc_bow"].shape[2]
        d_mask = (torch.arange(t, device=q_bow.device)[None, None, :]
                  < batch["doc_lens"][..., None])
        bow = maxsim_scores(q_bow, q_mask, batch["doc_bow"], d_mask,
                            score_dtype=cfg.score_dtype)
        agg = bow + batch["cls_scores"]
        # the outputs are replicated (``out_sh``): GSPMD takes the top k of
        # the whole scores on every device
        return topk_stable(constrain(agg, ()), 32)

    b, k = shape.dims["batch"], shape.dims["k_docs"]
    enc = 2.0 * b * cfg.max_query_len * (12 * cfg.n_layers * cfg.d_model ** 2)
    ms = 2.0 * b * k * cfg.max_query_len * cfg.max_doc_len * cfg.d_bow
    return Cell(cfg.name, shape.name, "serve", step, (pshapes, specs),
                (psh, bsh), (replicated(mesh), replicated(mesh)),
                model_flops=enc + ms)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh,
               overrides: dict | None = None) -> Cell:
    overrides = dict(overrides or {})
    grad_accum = overrides.pop("grad_accum", 1)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**{k: v for k, v in overrides.items()
                            if hasattr(cfg, k)})
    shape = shapes_for(cfg)[shape_name]
    if cfg.family in ("lm-dense", "lm-moe"):
        cell = lm_cell(cfg, shape, mesh, grad_accum=grad_accum)
    elif cfg.family == "gnn":
        cell = gnn_cell(cfg, shape, mesh)
    elif cfg.family == "recsys":
        cell = recsys_cell(cfg, shape, mesh)
    elif cfg.family == "retrieval":
        cell = retrieval_cell(cfg, shape, mesh)
    else:
        raise ValueError(cfg.family)
    return cell


def probe_plan(arch: str, overrides: dict | None = None
               ) -> tuple[dict, dict] | None:
    """Layer counts for the two probe runs (L=1, L=2) whose difference
    extrapolates a layered step's terms (``analysis.extrapolate_raw``).
    None = the arch has no layer loop. The port's trace counts every layer,
    so the dry run needs no probes; they stay to check that the two ways
    agree."""
    cfg = get_config(arch)
    if not hasattr(cfg, "n_layers"):
        return None
    common = dict(overrides or {})
    return ({**common, "n_layers": 1}, {**common, "n_layers": 2})


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch x shape) pairs + the paper's own serving cells."""
    out = []
    for arch in ("qwen2-0.5b", "qwen2-72b", "smollm-135m",
                 "granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                 "gatedgcn", "fm", "two-tower-retrieval", "dlrm-mlperf",
                 "autoint"):
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg):
            out.append((arch, shape_name))
    for shape_name in shapes_for(get_config("colberter")):
        out.append(("colberter", shape_name))
    return out
