"""Dense and MoE GQA transformer LM: parameters, init, the training loss,
prefill and KV-cache decode.

The parameters keep the reference's names and stacked ``(L, ...)`` shapes
(``embed`` (V, D), ``layers.wq`` (L, D, H*Dh), ...), and every product is
``x @ W``, so carrying weights across is a copy (``convert.
transformer_params_from_numpy``). The layers run as a Python loop.

Training: ``loss_fn`` is the reference's next-token loss (targets < 0
masked), differentiable in the parameters: ``forward`` runs the same
blockwise attention with autograd recording. With ``cfg.remat`` (the LMs'
default) each layer runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint(body)``: the backward keeps each layer's input
and recomputes the layer, and within it each kv chunk's score block
(``blockwise_attention``).

Serving: ``init_cache``, ``prefill`` and ``decode_step`` take the
reference's arguments and cache dict (``k``, ``v``, ``slot_pos``,
``length``), but write the cache IN PLACE, where the reference returns a new
one; ``length`` is a Python int. On a CUDA tensor each decode step's
attention goes to the hand-written ``flash_decode`` kernel, once per layer;
on CPU tensors the same call takes its plain version.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (INT32_MAX, apply_rope,
                                          blockwise_attention)
from repro_torch.models.layers import (constrain, cross_entropy_logits,
                                       dense_init, embed_init, embed_rows,
                                       rms_norm,
                                       swiglu_mlp, whole_heads, write_slot)


def _wsc(cfg: TransformerConfig, x, *spec):
    """Activation sharding constraint at the reference's sites: off unless
    the launcher set ``batch_axes``, and a no-op on plain tensors (see
    ``layers.constrain``); "TP" stands for ``cfg.tp_axis``."""
    if cfg.batch_axes is None:
        return x
    return constrain(x, tuple(cfg.tp_axis if a == "TP" else a for a in spec))


def padded_vocab(v: int) -> int:
    """Stored vocab rows round up to 512; tokens always index below the
    true vocab."""
    return -(-v // 512) * 512


def _table(cfg: TransformerConfig) -> dict[str, tuple[tuple, tuple, str]]:
    """name -> (shape, logical axes, init kind), under the reference's
    names. The logical axes ("fsdp", "tp") resolve to mesh axes through
    ``launch/mesh.mesh_axes``."""
    L, D, H, KV, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)
    V = padded_vocab(cfg.vocab_size)
    t = {"embed": ((V, D), ("tp", "fsdp"), "embed"),
         "final_norm": ((D,), (None,), "ones")}
    if not cfg.tie_embeddings:
        t["lm_head"] = ((D, V), ("fsdp", "tp"), "dense")
    lyr = {
        "attn_norm": ((L, D), (None, None), "ones"),
        "wq": ((L, D, H * Dh), (None, "fsdp", "tp"), "dense"),
        "wk": ((L, D, KV * Dh), (None, "fsdp", "tp"), "dense"),
        "wv": ((L, D, KV * Dh), (None, "fsdp", "tp"), "dense"),
        "wo": ((L, H * Dh, D), (None, "tp", "fsdp"), "dense"),
        "mlp_norm": ((L, D), (None, None), "ones"),
    }
    if cfg.qkv_bias:
        lyr["bq"] = ((L, H * Dh), (None, "tp"), "zeros")
        lyr["bk"] = ((L, KV * Dh), (None, "tp"), "zeros")
        lyr["bv"] = ((L, KV * Dh), (None, "tp"), "zeros")
    if cfg.moe is None:
        lyr["w_gate"] = ((L, D, F), (None, "fsdp", "tp"), "dense")
        lyr["w_up"] = ((L, D, F), (None, "fsdp", "tp"), "dense")
        lyr["w_down"] = ((L, F, D), (None, "tp", "fsdp"), "dense")
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        lyr["router"] = ((L, D, E), (None, "fsdp", None), "dense")
        lyr["w_gate"] = ((L, E, D, Fe), (None, "tp", "fsdp", None), "dense")
        lyr["w_up"] = ((L, E, D, Fe), (None, "tp", "fsdp", None), "dense")
        lyr["w_down"] = ((L, E, Fe, D), (None, "tp", None, "fsdp"), "dense")
        if cfg.moe.n_shared_experts:
            Fs = Fe * cfg.moe.n_shared_experts
            lyr["w_gate_s"] = ((L, D, Fs), (None, "fsdp", "tp"), "dense")
            lyr["w_up_s"] = ((L, D, Fs), (None, "fsdp", "tp"), "dense")
            lyr["w_down_s"] = ((L, Fs, D), (None, "tp", "fsdp"), "dense")
    t.update({f"layers/{k}": v for k, v in lyr.items()})
    return t


def param_table(cfg: TransformerConfig) -> dict[str, tuple[tuple, str]]:
    """name -> (shape, init kind), under the reference's names."""
    return {k: (shape, kind) for k, (shape, _, kind) in _table(cfg).items()}


def _nest(flat: dict) -> dict:
    """``{"layers/wq": a}`` -> ``{"layers": {"wq": a}}``, as the reference
    nests its parameters."""
    out: dict = {}
    for k, v in flat.items():
        if "/" in k:
            a, b = k.split("/", 1)
            out.setdefault(a, {})[b] = v
        else:
            out[k] = v
    return out


def param_shapes(cfg: TransformerConfig) -> dict:
    """The reference's nested parameter dict as empty ``meta`` tensors of
    the parameters' shapes and dtype."""
    return _nest({name: torch.empty(shape, dtype=cfg.param_dtype,
                                    device="meta")
                  for name, (shape, _) in param_table(cfg).items()})


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """The reference's nested tree of each parameter's logical axes."""
    return _nest({k: axes for k, (_, axes, _) in _table(cfg).items()})


def _cache_layout(cfg: TransformerConfig, batch: int,
                  max_len: int) -> dict[str, tuple[tuple, torch.dtype]]:
    """The KV cache's tensors: name -> (shape, dtype)."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (kv, cfg.dtype), "v": (kv, cfg.dtype),
            "slot_pos": ((batch, max_len), torch.int32)}


def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    """``init_cache``'s tensors as empty ``meta`` tensors (``length`` a
    0-d int32 one, as in the reference)."""
    out = {name: torch.empty(shape, dtype=dtype, device="meta")
           for name, (shape, dtype)
           in _cache_layout(cfg, batch, max_len).items()}
    out["length"] = torch.empty((), dtype=torch.int32, device="meta")
    return out


class TransformerLM(nn.Module):
    """The LM's fp32 master parameters (``param_table``), allocated
    uninitialised on ``device``; ``init_params`` or ``convert.
    transformer_params_from_numpy`` fill them."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ParameterDict()
        for name, (shape, _) in param_table(cfg).items():
            p = nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                         device=dev))
            if name.startswith("layers/"):
                self.layers[name.split("/", 1)[1]] = p
            else:
                self.register_parameter(name, p)

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        """Layer ``i``'s parameters (views of the stacked tensors)."""
        return {k: p[i] for k, p in self.layers.items()}

    def forward(self, tokens, positions=None):
        return forward(self.cfg, self, tokens, positions)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> TransformerLM:
    """The reference's init (one draw per parameter, in sorted name order)
    on ``generator``, copied into a model on ``device``."""
    model = TransformerLM(cfg, device)
    table = param_table(cfg)
    with torch.no_grad():
        for name in sorted(table):
            shape, kind = table[name]
            p = model.get_parameter(name.replace("/", "."))
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


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(cfg: TransformerConfig, x, lp, positions, *, cache=None,
           lengths=None, kv_out=None):
    """One transformer block. x: (B, S, D). Returns (y, aux), aux the MoE
    layer's aux loss (0 for a dense layer).

    Prefill: cache is None -> blockwise causal self-attention; with
    ``kv_out`` (this layer's (B, S, KV, Dh) k and v cache views) k and v
    are written into it. Decode: cache = (k_cache, v_cache, write_pos),
    this layer's (B, S_max, KV, Dh) cache views; the new k/v are written
    at ``write_pos`` in place (by a one-hot select over the whole cache
    with ``cfg.onehot_cache_update``) and the attention runs over the first
    ``lengths`` slots.
    """
    dt = cfg.dtype
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _wsc(cfg, x, cfg.batch_axes, None, None)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _wsc(cfg, h @ lp["wq"].to(dt), cfg.batch_axes, None, "TP")
    k = _wsc(cfg, h @ lp["wk"].to(dt), cfg.batch_axes, None, "TP")
    v = _wsc(cfg, h @ lp["wv"].to(dt), cfg.batch_axes, None, "TP")
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = whole_heads(q, -1, H).reshape(B, S, H, Dh)
    k = whole_heads(k, -1, KV).reshape(B, S, KV, Dh)
    v = whole_heads(v, -1, KV).reshape(B, S, KV, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        attn = blockwise_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                   q_positions=positions,
                                   kv_positions=positions,
                                   causal_skip=cfg.causal_skip,
                                   score_dtype=cfg.score_dtype)
        if kv_out is not None:
            for dst, new in zip(kv_out, (k, v)):
                # the cache-bound copy in the cache's layout (S over TP)
                dst.copy_(_wsc(cfg, new, cfg.batch_axes, "TP", None, None))
    else:
        k_cache, v_cache, write_pos = cache
        if cfg.onehot_cache_update:
            # the reference's SPMD-friendly masked write: elementwise over
            # the (sequence-sharded) cache, no slot selected
            hot = _one_hot(k_cache.shape[1], write_pos, k_cache.device)
            for dst, new in ((k_cache, k), (v_cache, v)):
                dst.copy_(torch.where(hot[None, :, None, None],
                                      new.to(dst.dtype), dst))
        else:
            write_slot(k_cache, 1, write_pos, k[:, 0])
            write_slot(v_cache, 1, write_pos, v[:, 0])
        attn = flash_decode(whole_heads(q, 2, KV).reshape(B, KV, H // KV, Dh),
                            k_cache, v_cache, lengths)

    attn = _wsc(cfg, attn.reshape(B, S, H * Dh), cfg.batch_axes, None, "TP")
    x = _wsc(cfg, x + attn @ lp["wo"].to(dt), cfg.batch_axes, None, None)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is None:
        y = swiglu_mlp(h, lp["w_gate"].to(dt), lp["w_up"].to(dt),
                       lp["w_down"].to(dt))
        aux = torch.zeros((), device=x.device)
    else:
        # groups = the batch rows: capacity and drops are per request
        y, aux = moe_lib.moe_ffn(
            h, lp, cfg.moe, dt, batch_axes=cfg.batch_axes,
            ep_axis=cfg.tp_axis if cfg.batch_axes is not None else None)
    return x + y, aux


def _one_hot(n: int, pos: int, device) -> torch.Tensor:
    """(n,) bool: True at ``pos`` alone."""
    return torch.arange(n, device=device) == pos


def _block(cfg: TransformerConfig, params: TransformerLM, i: int, x,
           positions, kv_out):
    """Layer ``i``, its parameters read inside (in the dry run that is
    where ZeRO-3 gathers them, so a recomputed layer gathers them again)."""
    return _layer(cfg, x, params.layer(i), positions, kv_out=kv_out)


def forward(cfg: TransformerConfig, params: TransformerLM, tokens,
            positions=None, *, kv_cache=None):
    """Token ids (B, S) -> (final hidden states (B, S, D), the aux loss
    summed over the layers (0 for a dense model)). With ``kv_cache`` (a
    cache dict) each layer's k and v are written into its slots 0..S-1.

    With ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint``: its input is what the backward keeps (with
    ``cfg.seq_shard_acts``, sequence-sharded over TP), and the layer is
    run again there. An MoE layer routes the same tokens to the same
    experts when it is run again: its top-k is stable and the router has
    no noise."""
    B, S = tokens.shape
    if positions is None:
        # made from the tokens, so that a DTensor batch gives its layout
        positions = (torch.zeros_like(tokens, dtype=torch.int32)
                     + torch.arange(S, dtype=torch.int32,
                                    device=tokens.device))
    x = _wsc(cfg, embed_rows(params.embed, tokens).to(cfg.dtype),
             cfg.batch_axes, None, None)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        kv_out = None
        if kv_cache is not None:
            kv_out = tuple(d if S == d.shape[1] else d[:, :S] for d in
                           (kv_cache["k"][i], kv_cache["v"][i]))
        if cfg.seq_shard_acts and S > 1:
            # the residual the layer starts from, sequence-sharded over TP
            # (Megatron-SP style); the layer gathers it back
            x = _wsc(cfg, x, cfg.batch_axes, "TP", None)
        block = partial(_block, cfg, params, i)
        if remat:
            x, aux = checkpoint(block, x, positions, kv_out,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = block(x, positions, kv_out)
        auxes.append(aux)
    # the last layer's residual sum reduced once here, where DTensor would
    # otherwise carry it as partial sums into the head's product
    x = _wsc(cfg, x, cfg.batch_axes, None, None)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, torch.stack(auxes).sum()


def logits_from_hidden(cfg: TransformerConfig, params: TransformerLM, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(cfg.dtype)
    spec = (cfg.batch_axes,) + (None,) * (logits.dim() - 2) + ("TP",)
    return _wsc(cfg, logits, *spec)


def loss_fn(cfg: TransformerConfig, params: TransformerLM, batch,
            aux_weight: float = 0.01):
    """Mean next-token CE over the targets >= 0 (fp32 logsumexp), plus
    ``aux_weight`` x the MoE layers' summed aux loss (0 for a dense model).
    batch: tokens and targets, (B, S) int. Returns (loss, {"ce", "aux"})."""
    x, aux = forward(cfg, params, batch["tokens"])
    logits = logits_from_hidden(cfg, params, x)
    targets = batch["targets"]
    mask = targets >= 0
    ce = cross_entropy_logits(logits, targets.clamp_min(0))
    loss = (ce * mask).sum() / mask.sum().clamp_min(1)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    dev = resolve_device(device)
    cache = {name: torch.zeros(shape, dtype=dtype, device=dev)
             for name, (shape, dtype)
             in _cache_layout(cfg, batch, max_len).items()}
    cache["slot_pos"].fill_(INT32_MAX)
    cache["length"] = 0
    return cache


@torch.no_grad()
def prefill(cfg: TransformerConfig, params: TransformerLM, tokens, cache):
    """Encode a prompt batch (B, S): fill slots 0..S-1 of ``cache`` in place
    and return (next-token logits (B, V), cache)."""
    B, S = tokens.shape
    if S > cache["k"].shape[2]:
        raise ValueError(f"prefill: {S} tokens do not fit a cache of "
                         f"{cache['k'].shape[2]} slots")
    x, _ = forward(cfg, params, tokens, kv_cache=cache)
    cache["slot_pos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                            device=tokens.device)
    cache["length"] = S
    return logits_from_hidden(cfg, params, x[:, -1, :]), cache


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: TransformerLM, tokens,
                positions, cache):
    """One decode step. tokens: (B, 1); positions: (B,). Writes slot
    ``cache["length"]`` of every layer in place and returns (logits (B, V),
    cache) with ``length`` advanced by one."""
    write_pos = int(cache["length"])
    if write_pos >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache's {write_pos} slots are "
                         "full")
    B = tokens.shape[0]
    x = embed_rows(params.embed, tokens).to(cfg.dtype)
    if cfg.onehot_cache_update:
        slot_pos = cache["slot_pos"]
        hot = _one_hot(slot_pos.shape[1], write_pos, slot_pos.device)
        slot_pos.copy_(torch.where(hot[None, :],
                                   positions[:, None].to(slot_pos.dtype),
                                   slot_pos))
    else:
        write_slot(cache["slot_pos"], 1, write_pos, positions)
    # The cache fills its slots in order (prefill writes 0..S-1, each step
    # writes at ``length``, shared by the batch), so the reference's
    # per-slot mask (slot_pos < INT32_MAX) is exactly the prefix of
    # length + 1 slots that the kernel takes.
    lengths = torch.full((B,), write_pos + 1, dtype=torch.int32,
                         device=x.device)
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, x, params.layer(i), positions[:, None],
                         cache=(cache["k"][i], cache["v"][i], write_pos),
                         lengths=lengths)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    cache["length"] = write_pos + 1
    return logits_from_hidden(cfg, params, x[:, -1, :]), cache


def smoke_config(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(
        1, cfg.n_kv_heads * 4 // cfg.n_heads), d_head=16, d_ff=128,
        vocab_size=512, attn_chunk=32, remat=False, max_seq_len=256)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(2, cfg.moe.top_k),
                                        d_ff_expert=64)
    return cfg.scaled(**kw)
