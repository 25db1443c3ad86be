"""Shared layers of the models: initializers, RMSNorm and LayerNorm, the
SwiGLU and GELU MLPs, the token cross-entropy.

Parameters are fp32 masters; compute casts them to the activation dtype
(bf16 by default), with the rounding points of the reference's layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal fan-in init, drawn on ``generator``'s device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale=0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Only the variance reduction runs in fp32: ``inv`` is cast to x's
    dtype and both products stay in it, as in the reference (this decides
    bf16 parity)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x * inv) * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12):
    """LayerNorm in fp32 (population variance), cast back to x's dtype, as
    in the reference; not ``F.layer_norm`` in the compute dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = d.square().mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu_mlp(x, w1, b1, w2, b2):
    """The encoder's FFN: tanh-approximate GELU (the reference's
    ``jax.nn.gelu(approximate=True)``, not torch's default erf form);
    weights and biases already in the compute dtype."""
    h = F.gelu(x @ w1 + b1, approximate="tanh")
    return h @ w2 + b2


def swiglu_mlp(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP. x: (..., D); weights already in compute dtype."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def cross_entropy_logits(logits, targets, z_loss: float = 0.0):
    """Token CE with an fp32 logsumexp; logits (..., V) any float dtype,
    targets (...) int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, targets[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
