"""Mixture-of-Experts FFN with GShard-style grouped capacity dispatch.

Tokens are dispatched within groups (the batch rows: each request's tokens
compete for its own capacity, so a request's answer does not depend on the
batch it came in): position-in-expert is a per-group cumsum in token-major,
then top-k order, and a token past its expert's capacity is dropped. The
expert products are batched matmuls over a (G, E, C, D) buffer; the router
is softmax-then-top-k (ties to the lower expert index, as
``jax.lax.top_k``) with the Switch load-balance aux loss.

The buffer is filled by a scatter without accumulation and read back by a
gather (every kept row has a slot of its own; dropped rows all land, as
zeros, in one overflow row that is cut off), so a call gives the same bits
on every run: no ``index_add_`` atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.maxsim import topk_stable
from repro_torch.models.layers import constrain, swiglu_mlp


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Slots an expert has per group: tokens x k x capacity factor / E,
    at least 8, rounded up to a multiple of 8."""
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(x, router_w, cfg: MoEConfig):
    """x: (G, T, D) -> (weights (G, T, k) in x's dtype, experts (G, T, k)
    int64, aux loss fp32 scalar). The logits are an fp32 product of x cast
    up and the router weight (the caller keeps TF32 off on the card)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = topk_stable(probs, cfg.top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing aux loss (per group, then averaged): the
    # share of each expert among the group's T x k choices
    me = probs.mean(dim=1)                                        # (G, E)
    counts = F.one_hot(experts.flatten(1), cfg.n_experts).sum(1)  # (G, E)
    ce = counts.float() * (1.0 / (experts.shape[1] * cfg.top_k))
    aux = cfg.n_experts * (me * ce).sum(-1).mean()
    return weights.to(x.dtype), experts, aux


def dispatch(experts, n_experts: int, cap: int):
    """Slots of the (token, choice) pairs, token-major then k: experts
    (G, T, k) -> (dest (G, T*k) into the flat (E*C + 1) buffer, E*C the
    overflow row; keep (G, T*k), False where the expert was full)."""
    g = experts.shape[0]
    flat_e = experts.reshape(g, -1)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)       # (G, T*k, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        -1, flat_e[..., None])[..., 0] - 1
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    return dest, keep


def moe_ffn(x, params, cfg: MoEConfig, compute_dtype=torch.bfloat16, *,
            batch_axes=None, ep_axis=None):
    """x: (G, T, D) or (T, D) (one group). params: router (D, E), w_gate /
    w_up (E, D, F), w_down (E, F, D), optional shared expert w_gate_s /
    w_up_s (D, Fs) and w_down_s (Fs, D). Returns (y like x, aux loss).
    batch_axes / ep_axis: the expert buffer's sharding constraint (set by
    the launcher; it only redistributes DTensors)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)
    xc = x.to(compute_dtype)

    weights, experts, aux = route(xc, params["router"], cfg)
    dest, keep = dispatch(experts, e, c)
    keep_c = keep[..., None].to(compute_dtype)
    x_rep = xc.repeat_interleave(k, dim=1) * keep_c              # (G, T*k, D)
    idx = dest[..., None].expand(-1, -1, d)
    buf = torch.zeros(g, e * c + 1, d, dtype=compute_dtype, device=x.device)
    buf = buf.scatter(1, idx, x_rep)[:, :-1].reshape(g, e, c, d)
    spec = ((batch_axes, ep_axis, None, None)
            if batch_axes is not None or ep_axis is not None else None)
    buf = constrain(buf, spec)

    # expert compute: a batched SwiGLU over the expert dim
    w_gate, w_up, w_down = (params[n].to(compute_dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    gate = torch.einsum("gecd,edf->gecf", buf, w_gate)
    up = torch.einsum("gecd,edf->gecf", buf, w_up)
    out = constrain(torch.einsum("gecf,efd->gecd", F.silu(gate) * up,
                                 w_down), spec)

    # combine: gather back, weight, sum over k
    flat_out = torch.cat([out.reshape(g, e * c, d),
                          out.new_zeros(g, 1, d)], dim=1)        # (G, E*C+1, D)
    y = flat_out.gather(1, idx)
    y = y * (weights.reshape(g, t * k, 1) * keep_c)
    y = y.reshape(g, t, k, d).sum(dim=2)

    if "w_gate_s" in params:
        y = y + swiglu_mlp(xc, params["w_gate_s"].to(compute_dtype),
                           params["w_up_s"].to(compute_dtype),
                           params["w_down_s"].to(compute_dtype))
    y = y.to(x.dtype)
    return (y[0] if squeeze else y), aux


def moe_ffn_dense_reference(x, params, cfg: MoEConfig):
    """O(T*E) oracle: every expert on every token in fp32, masked combine;
    no capacity. Tests only."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    xf = x.float()
    weights, experts, aux = route(xf, params["router"], cfg)
    gate = torch.einsum("gtd,edf->gtef", xf, params["w_gate"].float())
    up = torch.einsum("gtd,edf->gtef", xf, params["w_up"].float())
    out = torch.einsum("gtef,efd->gted", F.silu(gate) * up,
                       params["w_down"].float())
    mask = F.one_hot(experts, cfg.n_experts).float()
    comb = torch.einsum("gtke,gtk->gte", mask, weights.float())
    y = torch.einsum("gte,gted->gtd", comb, out)
    if "w_gate_s" in params:
        y = y + swiglu_mlp(xf, params["w_gate_s"].float(),
                           params["w_up_s"].float(),
                           params["w_down_s"].float())
    y = y.to(x.dtype)
    return (y[0] if squeeze else y), aux
