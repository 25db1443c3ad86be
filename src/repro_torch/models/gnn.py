"""GatedGCN (edge-gated message passing, arXiv:2003.00982) over an edge list.

Node states are gathered along the edges, per-edge messages computed, and
summed back into their destination nodes. Both the gathers' backward and the
sums go through ``segment_ops.Segments``: each edge list is sorted once per
forward, stably, and every sum runs in edge order with no atomics, so a step
gives the same bits on every run.

Edge lists may be padded with ``dst = n_nodes`` (the reference's ``pad512``
and ``sample_block(pad_edges_to=)`` contract). A pad gathers a zero row
instead of indexing past the nodes, and reaches no message, gate sum or
gradient: a padded batch gives its unpadded batch's logits and gradients.
(The reference's ``jnp.take`` fills a pad's row with NaN, which its
segment sums drop in the forward but which reaches every gradient.)

Deviation from the paper, as in the reference: BatchNorm -> LayerNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, layer_norm
from repro_torch.models.segment_ops import Segments
from repro_torch.train.checkpoint import unflatten


def _table(cfg: GNNConfig, d_in: int) -> dict[str, tuple[tuple, str]]:
    """name -> (shape, init kind), under the reference's names."""
    L, D = cfg.n_layers, cfg.d_hidden
    t = {
        "embed_h/w": ((d_in, D), "dense"),
        "embed_h/b": ((D,), "zeros"),
        "embed_e_src": ((D, D), "dense"),
        "embed_e_dst": ((D, D), "dense"),
        "out/w": ((D, cfg.n_classes), "dense"),
        "out/b": ((cfg.n_classes,), "zeros"),
    }
    for n in ("A", "B", "C", "Dm", "E"):
        t[f"layers/{n}"] = ((L, D, D), "dense")
    for n in ("h_scale", "e_scale"):
        t[f"layers/{n}"] = ((L, D), "ones")
    for n in ("h_bias", "e_bias"):
        t[f"layers/{n}"] = ((L, D), "zeros")
    return t


def param_shapes(cfg: GNNConfig, d_in: int) -> dict:
    """The reference's nested parameter dict as empty ``meta`` tensors."""
    return unflatten({k: torch.empty(s, dtype=cfg.param_dtype, device="meta")
                      for k, (s, _) in _table(cfg, d_in).items()})


def init_params(cfg: GNNConfig, generator: torch.Generator, d_in: int,
                device="cuda") -> dict:
    """The reference's init kinds (LeCun-normal fan-in matrices, ones for
    the norm scales, zeros for biases), one draw per matrix in sorted name
    order on ``generator``, placed on ``device``."""
    dev = resolve_device(device)
    flat = {}
    for name, (shape, kind) in sorted(_table(cfg, d_in).items()):
        if kind == "dense":
            flat[name] = dense_init(generator, shape, in_axis=-2,
                                    dtype=cfg.param_dtype).to(dev)
        else:
            flat[name] = torch.full(shape, float(kind == "ones"),
                                    dtype=cfg.param_dtype, device=dev)
    return unflatten(flat)


def _layer(h, e, lp, src: Segments, dst: Segments, dt):
    hs = src.gather(h)                                      # (E, D)
    hd = dst.gather(h)
    e_pre = e @ lp["C"].to(dt) + hd @ lp["Dm"].to(dt) + hs @ lp["E"].to(dt)
    e_new = e + F.relu(layer_norm(e_pre, lp["e_scale"], lp["e_bias"]))
    gate = torch.sigmoid(e_new.float())
    msg = gate * (hs @ lp["B"].to(dt)).float()
    agg = (dst.sum(msg) / (dst.sum(gate) + 1e-6)).to(dt)
    h_pre = h @ lp["A"].to(dt) + agg
    h_new = h + F.relu(layer_norm(h_pre, lp["h_scale"], lp["h_bias"]))
    return h_new, e_new


def forward(cfg: GNNConfig, params, node_feats, edge_src, edge_dst):
    """Per-node logits (N, n_classes) in the compute dtype. ``edge_dst ==
    N`` marks a pad edge; ``edge_src`` indexes real nodes."""
    dt = cfg.dtype
    n_nodes = node_feats.shape[0]
    src = Segments(edge_src, n_nodes)
    dst = Segments(edge_dst, n_nodes, padded=True)
    h = (node_feats.to(dt) @ params["embed_h"]["w"].to(dt)
         + params["embed_h"]["b"].to(dt))
    e = (src.gather(h) @ params["embed_e_src"].to(dt)
         + dst.gather(h) @ params["embed_e_dst"].to(dt))
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.remat:
            h, e = checkpoint(_layer, h, e, lp, src, dst, dt,
                              use_reentrant=False)
        else:
            h, e = _layer(h, e, lp, src, dst, dt)
    return h @ params["out"]["w"].to(dt) + params["out"]["b"].to(dt)


def loss_fn(cfg: GNNConfig, params, batch):
    """Node classification (full graph; a sampled block's ``label_nodes``)
    or graph classification (``graph_ids``: the mean of each graph's node
    logits): mean CE with an fp32 logsumexp. Returns (loss, {"ce": loss})."""
    logits = forward(cfg, params, batch["node_feats"], batch["edge_src"],
                     batch["edge_dst"])
    lf = logits.float()
    labels = batch["labels"].long()
    if "graph_ids" in batch:                       # graph-level readout
        graphs = Segments(batch["graph_ids"], labels.shape[0])
        cnt = graphs.counts().float()
        lf = graphs.sum(lf) / torch.clamp(cnt[:, None], min=1.0)
    elif "label_nodes" in batch:                   # minibatch: seed nodes
        lf = Segments(batch["label_nodes"], lf.shape[0]).gather(lf)
    gold = lf.gather(-1, labels[:, None])[:, 0]
    loss = (torch.logsumexp(lf, dim=-1) - gold).mean()
    return loss, {"ce": loss}


def smoke_config(cfg: GNNConfig) -> GNNConfig:
    return cfg.scaled(n_layers=3, d_hidden=16, n_classes=5)
