"""Dense and MoE GQA transformer LM: parameters, init, the training loss,
prefill and KV-cache decode.

The parameters keep the reference's names and stacked ``(L, ...)`` shapes
(``embed`` (V, D), ``layers.wq`` (L, D, H*Dh), ...), and every product is
``x @ W``, so carrying weights across is a copy (``convert.
transformer_params_from_numpy``). The layers run as a Python loop.

Training: ``loss_fn`` is the reference's next-token loss (targets < 0
masked), differentiable in the parameters: ``forward`` runs the same
blockwise attention with autograd recording.

Serving: ``init_cache``, ``prefill`` and ``decode_step`` take the
reference's arguments and cache dict (``k``, ``v``, ``slot_pos``,
``length``), but write the cache IN PLACE, where the reference returns a new
one; ``length`` is a Python int. On a CUDA tensor each decode step's
attention goes to the hand-written ``flash_decode`` kernel, once per layer;
on CPU tensors the same call takes its plain version.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (INT32_MAX, apply_rope,
                                          blockwise_attention)
from repro_torch.models.layers import (cross_entropy_logits, dense_init,
                                       embed_init, rms_norm, swiglu_mlp)


def padded_vocab(v: int) -> int:
    """Stored vocab rows round up to 512; tokens always index below the
    true vocab."""
    return -(-v // 512) * 512


def param_table(cfg: TransformerConfig) -> dict[str, tuple[tuple, str]]:
    """name -> (shape, init kind), under the reference's names."""
    L, D, H, KV, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)
    t = {"embed": ((padded_vocab(cfg.vocab_size), D), "embed"),
         "final_norm": ((D,), "ones")}
    if not cfg.tie_embeddings:
        t["lm_head"] = ((D, padded_vocab(cfg.vocab_size)), "dense")
    lyr = {
        "attn_norm": ((L, D), "ones"),
        "wq": ((L, D, H * Dh), "dense"),
        "wk": ((L, D, KV * Dh), "dense"),
        "wv": ((L, D, KV * Dh), "dense"),
        "wo": ((L, H * Dh, D), "dense"),
        "mlp_norm": ((L, D), "ones"),
    }
    if cfg.qkv_bias:
        lyr["bq"] = ((L, H * Dh), "zeros")
        lyr["bk"] = ((L, KV * Dh), "zeros")
        lyr["bv"] = ((L, KV * Dh), "zeros")
    if cfg.moe is None:
        lyr["w_gate"] = ((L, D, F), "dense")
        lyr["w_up"] = ((L, D, F), "dense")
        lyr["w_down"] = ((L, F, D), "dense")
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        lyr["router"] = ((L, D, E), "dense")
        lyr["w_gate"] = ((L, E, D, Fe), "dense")
        lyr["w_up"] = ((L, E, D, Fe), "dense")
        lyr["w_down"] = ((L, E, Fe, D), "dense")
        if cfg.moe.n_shared_experts:
            Fs = Fe * cfg.moe.n_shared_experts
            lyr["w_gate_s"] = ((L, D, Fs), "dense")
            lyr["w_up_s"] = ((L, D, Fs), "dense")
            lyr["w_down_s"] = ((L, Fs, D), "dense")
    t.update({f"layers/{k}": v for k, v in lyr.items()})
    return t


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

    def forward(self, tokens, positions=None, *, collect_kv: bool = False):
        return forward(self.cfg, self, tokens, positions,
                       collect_kv=collect_kv)


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
           lengths=None):
    """One transformer block. x: (B, S, D).

    Prefill: cache is None -> blockwise causal self-attention; returns
    (y, aux, (k, v)). Decode: cache = (k_cache, v_cache, write_pos), this
    layer's (B, S_max, KV, Dh) cache views; the new k/v are written at
    ``write_pos`` in place and the attention runs over the first
    ``lengths`` slots; returns (y, aux, None). aux is the MoE layer's aux
    loss (0 for a dense layer).
    """
    dt = cfg.dtype
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"].to(dt)
    k = h @ lp["wk"].to(dt)
    v = h @ lp["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = apply_rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, Dh)

    if cache is None:
        attn = blockwise_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                   q_positions=positions,
                                   kv_positions=positions)
        kv_out = (k, v)
    else:
        k_cache, v_cache, write_pos = cache
        k_cache[:, write_pos] = k[:, 0]
        v_cache[:, write_pos] = v[:, 0]
        attn = flash_decode(q.reshape(B, KV, H // KV, Dh), k_cache, v_cache,
                            lengths)
        kv_out = None

    x = x + attn.reshape(B, S, H * Dh) @ lp["wo"].to(dt)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is None:
        y = swiglu_mlp(h, lp["w_gate"].to(dt), lp["w_up"].to(dt),
                       lp["w_down"].to(dt))
        aux = torch.zeros((), device=x.device)
    else:
        # groups = the batch rows: capacity and drops are per request
        y, aux = moe_lib.moe_ffn(h, lp, cfg.moe, dt)
    return x + y, aux, kv_out


def forward(cfg: TransformerConfig, params: TransformerLM, tokens,
            positions=None, *, collect_kv: bool = False):
    """Token ids (B, S) -> (final hidden states (B, S, D), the aux loss
    summed over the layers (0 for a dense model), stacked (L, B, S, KV, Dh)
    k and v or None)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = params.embed[tokens].to(cfg.dtype)
    ks, vs, auxes = [], [], []
    for i in range(cfg.n_layers):
        x, aux, (k, v) = _layer(cfg, x, params.layer(i), positions)
        auxes.append(aux)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, torch.stack(auxes).sum(), (
        (torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def logits_from_hidden(cfg: TransformerConfig, params: TransformerLM, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(cfg.dtype)


def loss_fn(cfg: TransformerConfig, params: TransformerLM, batch,
            aux_weight: float = 0.01):
    """Mean next-token CE over the targets >= 0 (fp32 logsumexp), plus
    ``aux_weight`` x the MoE layers' summed aux loss (0 for a dense model).
    batch: tokens and targets, (B, S) int. Returns (loss, {"ce", "aux"})."""
    x, aux, _ = forward(cfg, params, batch["tokens"])
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
    x, _, (k_new, v_new) = forward(cfg, params, tokens, collect_kv=True)
    cache["k"][:, :, :S] = k_new
    cache["v"][:, :, :S] = v_new
    del k_new, v_new
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
    x = params.embed[tokens].to(cfg.dtype)
    cache["slot_pos"][:, write_pos] = positions
    # The cache fills its slots in order (prefill writes 0..S-1, each step
    # writes at ``length``, shared by the batch), so the reference's
    # per-slot mask (slot_pos < INT32_MAX) is exactly the prefix of
    # length + 1 slots that the kernel takes.
    lengths = torch.full((B,), write_pos + 1, dtype=torch.int32,
                         device=x.device)
    for i in range(cfg.n_layers):
        x, _, _ = _layer(cfg, x, params.layer(i), positions[:, None],
                         cache=(cache["k"][i], cache["v"][i], write_pos),
                         lengths=lengths)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    cache["length"] = write_pos + 1
    return logits_from_hidden(cfg, params, x[:, -1, :]), cache


def smoke_config(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(
        1, cfg.n_kv_heads * 4 // cfg.n_heads), d_head=16, d_ff=128,
        vocab_size=512, attn_chunk=32, max_seq_len=256)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(2, cfg.moe.top_k),
                                        d_ff_expert=64)
    return cfg.scaled(**kw)
