"""ColBERTer-style late-interaction encoder: a distilBERT-like backbone with
a CLS head (128-d single vector, candidate generation) and a BOW head (32-d
per-token vectors, MaxSim re-ranking), as used by ESPN, and its in-batch
contrastive training loss.

Bidirectional attention, learned positional embeddings, GELU FFN, post-LN,
as the reference's ``repro.models.colberter``. The parameters keep the
reference's names and stacked ``(L, ...)`` shapes (``embed``, ``pos_embed``,
``embed_norm/{scale,bias}``, ``layers/{wq, ..., ln2/bias}``, ``cls_head``,
``bow_head``, ``score_scale``), and every product is ``x @ W``, so carrying
weights across is a copy (``convert.colberter_params_from_numpy``). The
layers run as a Python loop; attention is the blockwise online-softmax
attention of ``models/attention.py``, with the padding mask passed as fake
key positions. ``encode`` is the serving form (under ``no_grad``);
``contrastive_loss`` runs the same body with autograd recording (each layer
under ``torch.utils.checkpoint`` with ``cfg.remat``, off by default, as in
the reference), and its all-pairs MaxSim is the plain
``core/maxsim.maxsim_scores`` (the CUDA ``maxsim`` kernel has no backward
and stays on the serving path).
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ColberterConfig
from repro_torch.core.maxsim import maxsim_scores
from repro_torch.device import resolve_device
from repro_torch.models.attention import INT32_MAX, blockwise_attention
from repro_torch.models.layers import (dense_init, embed_init, embed_rows,
                                       gelu_mlp, layer_norm)


def param_table(cfg: ColberterConfig) -> dict[str, tuple[tuple, str]]:
    """name -> (shape, init kind), under the reference's names."""
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    t = {
        "embed": ((V, D), "embed"),
        "pos_embed": ((cfg.max_doc_len + 8, D), "embed"),
        "embed_norm/scale": ((D,), "ones"),
        "embed_norm/bias": ((D,), "zeros"),
        "cls_head": ((D, cfg.d_cls), "dense"),
        "bow_head": ((D, cfg.d_bow), "dense"),
        "score_scale": ((), "ones"),           # learned CLS/BOW mixing weight
    }
    lyr = {
        "wq": ((L, D, D), "dense"), "bq": ((L, D), "zeros"),
        "wk": ((L, D, D), "dense"), "bk": ((L, D), "zeros"),
        "wv": ((L, D, D), "dense"), "bv": ((L, D), "zeros"),
        "wo": ((L, D, D), "dense"), "bo": ((L, D), "zeros"),
        "ln1/scale": ((L, D), "ones"), "ln1/bias": ((L, D), "zeros"),
        "w1": ((L, D, F), "dense"), "b1": ((L, F), "zeros"),
        "w2": ((L, F, D), "dense"), "b2": ((L, D), "zeros"),
        "ln2/scale": ((L, D), "ones"), "ln2/bias": ((L, D), "zeros"),
    }
    t.update({f"layers/{k}": v for k, v in lyr.items()})
    return t


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def param_shapes(cfg: ColberterConfig) -> dict:
    """The nested parameter tree as ``meta`` tensors (shape and dtype, no
    storage): the counterpart of the reference's ``ShapeDtypeStruct``s."""
    return _nest({k: torch.empty(s, dtype=cfg.param_dtype, device="meta")
                  for k, (s, _) in param_table(cfg).items()})


class Colberter(nn.Module):
    """The encoder's fp32 master parameters (``param_table``), allocated
    uninitialised on ``device`` under the reference's names ("/" becomes
    ".": ``layers.ln1.scale``); ``init_params`` or ``convert.
    colberter_params_from_numpy`` fill them."""

    def __init__(self, cfg: ColberterConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        for name, (shape, _) in param_table(cfg).items():
            *parents, leaf = name.split("/")
            mod = self
            for p in parents:
                if not hasattr(mod, p):
                    mod.add_module(p, nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=dev)))

    def param(self, name: str) -> torch.Tensor:
        """The parameter under its reference name (``layers/ln1/scale``)."""
        return self.get_parameter(name.replace("/", "."))

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        """Layer ``i``'s parameters (views of the stacked tensors), under
        the reference's names within a layer (``wq``, ``ln1/scale``)."""
        return {n.replace(".", "/"): p[i]
                for n, p in self.layers.named_parameters()}

    def forward(self, tokens, mask=None):
        return encode(self.cfg, self, tokens, mask)


def init_params(cfg: ColberterConfig, generator: torch.Generator,
                device="cuda") -> Colberter:
    """The reference's init (one draw per parameter, in sorted name order)
    on ``generator``, copied into a model on ``device``."""
    model = Colberter(cfg, device)
    table = param_table(cfg)
    with torch.no_grad():
        for name in sorted(table):
            shape, kind = table[name]
            p = model.param(name)
            if kind == "ones":
                p.fill_(1.0)
            elif kind == "zeros":
                p.zero_()
            elif kind == "embed":
                p.copy_(embed_init(generator, shape, cfg.param_dtype))
            else:
                p.copy_(dense_init(generator, shape, in_axis=-2,
                                   dtype=cfg.param_dtype))
    return model


def _l2_normed(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return xf / xf.norm(dim=-1, keepdim=True).clamp_min(1e-6)


@torch.no_grad()
def encode(cfg: ColberterConfig, params: Colberter, tokens, mask=None):
    """tokens: (B, S) int (token 0 = [CLS]; pads < 0, or ``mask`` given),
    a tensor or a numpy array, moved to the parameters' device.

    Returns (cls (B, d_cls) fp32 L2-normed, bow (B, S, d_bow) L2-normed in
    the compute dtype and zero at pads, mask (B, S) bool).
    """
    return _encode(cfg, params, tokens, mask)


def _encode(cfg: ColberterConfig, params: Colberter, tokens, mask=None):
    """``encode``'s body, differentiable in the parameters."""
    dt = cfg.dtype
    dev = params.embed.device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    mask = (tokens >= 0 if mask is None
            else torch.as_tensor(mask, device=dev).bool())
    tok = tokens.clamp_min(0).long()
    x = (embed_rows(params.embed, tok)
         + params.pos_embed[None, :S, :]).to(dt)
    x = layer_norm(x, params.embed_norm.scale, params.embed_norm.bias,
                   cfg.norm_eps)
    # the mask as fake key positions: valid keys at 0 (<= every query's
    # position), pads at INT32_MAX, which the non-causal mask drops
    kv_pos = torch.where(mask, 0, INT32_MAX).to(torch.int32)
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        block = partial(_layer, cfg, params, i)
        x = (checkpoint(block, x, q_pos, kv_pos, use_reentrant=False,
                        preserve_rng_state=False)
             if remat else block(x, q_pos, kv_pos))
    cls = _l2_normed(x[:, 0, :] @ params.cls_head.to(dt))
    bow = _l2_normed(x @ params.bow_head.to(dt)) * mask[..., None]
    return cls, bow.to(dt), mask


def _layer(cfg: ColberterConfig, params: Colberter, i: int, x, q_pos,
           kv_pos):
    """Encoder layer ``i`` (post-LN), its parameters read inside."""
    dt = cfg.dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    Dh = cfg.d_model // H
    lp = params.layer(i)
    q = (x @ lp["wq"].to(dt) + lp["bq"].to(dt)).reshape(B, S, H, Dh)
    k = (x @ lp["wk"].to(dt) + lp["bk"].to(dt)).reshape(B, S, H, Dh)
    v = (x @ lp["wv"].to(dt) + lp["bv"].to(dt)).reshape(B, S, H, Dh)
    a = blockwise_attention(q, k, v, causal=False, chunk=cfg.attn_chunk,
                            q_positions=q_pos, kv_positions=kv_pos)
    o = a.reshape(B, S, cfg.d_model) @ lp["wo"].to(dt) + lp["bo"].to(dt)
    x = layer_norm(x + o, lp["ln1/scale"], lp["ln1/bias"], cfg.norm_eps)
    f = gelu_mlp(x, lp["w1"].to(dt), lp["b1"].to(dt), lp["w2"].to(dt),
                 lp["b2"].to(dt))
    return layer_norm(x + f, lp["ln2/scale"], lp["ln2/bias"], cfg.norm_eps)


def contrastive_loss(cfg: ColberterConfig, params: Colberter, batch):
    """In-batch late-interaction contrastive loss (ColBERT-style training).

    batch: query_tokens (B, Sq), pos_doc_tokens (B, Sd). Each query's
    positive is its own doc; the other in-batch docs are negatives. Score =
    alpha * CLS dot + MaxSim(BOW). Returns (loss, {"ce", "alpha"}).
    """
    q_cls, q_bow, q_mask = _encode(cfg, params, batch["query_tokens"])
    d_cls, d_bow, d_mask = _encode(cfg, params, batch["pos_doc_tokens"])
    n = q_bow.shape[0]
    # all pairs: queries x docs
    sim_bow = maxsim_scores(q_bow, q_mask, d_bow[None].expand(n, -1, -1, -1),
                            d_mask[None].expand(n, -1, -1))
    sim_cls = q_cls @ d_cls.T
    alpha = params.score_scale.float()
    # normalize by query length so logits stay O(1) at init (MaxSim sums
    # over Lq tokens); a fixed temperature sharpens the in-batch softmax
    n_q = q_mask.sum(dim=-1, keepdim=True).float().clamp_min(1.0)
    logits = (sim_bow / n_q + alpha * sim_cls) * 8.0
    labels = torch.arange(n, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    loss = (lse - logits[labels, labels]).mean()
    return loss, {"ce": loss, "alpha": alpha}


def smoke_config(cfg: ColberterConfig) -> ColberterConfig:
    return cfg.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab_size=512, d_cls=16, d_bow=8,
                      max_doc_len=24, max_query_len=8, attn_chunk=16)
